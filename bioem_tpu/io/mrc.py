"""MRC file parsing with endianness auto-detection.

JAX equivalent of reference ``include/mrc.h`` (test_mrc /
check_one_MRC, /root/reference/include/mrc.h:72-237): the endianness is
guessed by counting header-field range violations under both byte orders and
picking the order with fewer. Only mode-2 (32-bit float) data is accepted,
as in the reference (mrc.h:230-233).
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass

import numpy as np


@dataclass
class MRCHeader:
    nc: int
    nr: int
    ns: int
    mode: int
    nsymbt: int
    swap: bool  # True if byte-swapped relative to native little-endian

    @property
    def byteorder(self) -> str:
        return ">" if self.swap else "<"


def _range_violations(raw: bytes, order: str) -> int:
    """Reference test_mrc (mrc.h:72-149): count implausible header values."""
    ints = struct.unpack(order + "10i", raw[0:40])
    nc, nr, ns, _mode, ncs, nrs, nss, mx, my, mz = ints
    alpha, beta, gamma = struct.unpack(order + "3f", raw[52:64])
    v = 0
    for x in (nc, nr, ns, mx, my, mz):
        v += x > 5000
        v += x < 0
    for x in (ncs, nrs, nss):
        v += x > 5000
        v += x < -5000
    for x in (alpha, beta, gamma):
        v += x > 360.0
        v += x < -360.0
    return v


def read_mrc_header(path: str) -> MRCHeader:
    with open(path, "rb") as f:
        raw = f.read(1024)
    if len(raw) < 1024:
        raise IOError(f"Reading MRC header: {path}")
    v_le = _range_violations(raw, "<")
    v_be = _range_violations(raw, ">")
    swap = not (v_le < v_be)
    order = ">" if swap else "<"
    if (v_le if not swap else v_be) > 0:
        warnings.warn(
            f"{min(v_le, v_be)} header field range violations detected in file {path}"
        )
    nc, nr, ns, mode = struct.unpack(order + "4i", raw[0:16])
    (nsymbt,) = struct.unpack(order + "i", raw[92:96])
    if mode != 2:
        raise IOError(f"MRC mode: {mode}. Currently mode 2 is the only one allowed")
    return MRCHeader(nc=nc, nr=nr, ns=ns, mode=mode, nsymbt=nsymbt, swap=swap)


def read_mrc_data(path: str, hdr: MRCHeader) -> np.ndarray:
    """Raw (ns, nr, nc) float32 sections in file order."""
    count = hdr.nc * hdr.nr * hdr.ns
    with open(path, "rb") as f:
        f.seek(1024 + hdr.nsymbt)
        dt = np.dtype(hdr.byteorder + "f4")
        data = np.fromfile(f, dtype=dt, count=count)
    if data.size != count:
        raise IOError(f"Converting Data: {path}")
    return data.astype(np.float32).reshape(hdr.ns, hdr.nr, hdr.nc)


def write_mrc(path: str, stack: np.ndarray, pixel_size: float = 1.0) -> None:
    """Write a mode-2 MRC stack (ns, nr, nc) — convenience for tests/tools."""
    stack = np.asarray(stack, dtype="<f4")
    if stack.ndim == 2:
        stack = stack[None]
    ns, nr, nc = stack.shape
    hdr = np.zeros(256, dtype="<i4")
    hdr[0:3] = (nc, nr, ns)
    hdr[3] = 2  # mode
    hdr[7:10] = (nc, nr, ns)
    fhdr = hdr.view("<f4")
    fhdr[10:13] = (nc * pixel_size, nr * pixel_size, ns * pixel_size)
    fhdr[13:16] = (90.0, 90.0, 90.0)
    hdr[16:19] = (1, 2, 3)
    fhdr[19] = float(stack.min())
    fhdr[20] = float(stack.max())
    fhdr[21] = float(stack.mean())
    with open(path, "wb") as f:
        f.write(hdr.tobytes())
        f.write(stack.tobytes())
