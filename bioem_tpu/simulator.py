"""Forward simulator: synthesise the maximum-a-posteriori image.

JAX equivalent of the reference's --PrintBestCalMap mode
(/root/reference/bioem.cpp:624-657, 1925-2085): project the model at the
given best orientation, convolve with the single best CTF/PSF kernel,
inverse-FFT to real space, apply norm/offset (+ optional Gaussian noise) and
write the BESTMAP gnuplot-format file — or report the squared difference to
a reference image (BestmapCalcCC).

This doubles as the framework's self-consistency test driver: posterior-max
parameters should regenerate the observed image (SURVEY.md §4.6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, TextIO

import numpy as np

from .defs import FILE_BESTMAP
from .params import BestParams, BioEMParams, best_to_params, make_ctf_grid
from .core.ctf import build_ctf_bank
from .core.orientations import OrientationSet
from .io.model_io import Model


@dataclass
class BestMapResult:
    conv_map: np.ndarray  # (N, N) convolved projection (normalised inverse FFT)
    sum_conv: float
    sumsquare_conv: float


def _project_numpy(p: BioEMParams, model: Model, orient: np.ndarray, use_quat: bool) -> np.ndarray:
    """Host-side projection for the single best orientation.

    Reuses the engine's vectorised projection on CPU via the oracle-style
    formulas (reference bioem.cpp:1604-1853) — one orientation, so NumPy is
    plenty fast and keeps the simulator free of device dependencies.
    """
    n = p.n_pixels
    if use_quat:
        q0, q1, q2, q3 = (float(x) for x in orient[:4])
        rm = np.array(
            [
                [1 - 2 * q1 * q1 - 2 * q2 * q2, 2 * (q0 * q1 + q2 * q3), 2 * (q0 * q2 - q1 * q3)],
                [2 * (q0 * q1 - q2 * q3), 1 - 2 * q0 * q0 - 2 * q2 * q2, 2 * (q1 * q2 + q0 * q3)],
                [2 * (q0 * q2 + q1 * q3), 2 * (q1 * q2 - q0 * q3), 1 - 2 * q0 * q0 - 2 * q1 * q1],
            ]
        )
    else:
        a, b, g = (float(x) for x in orient[:3])
        ca, sa, cb, sb, cg, sg = math.cos(a), math.sin(a), math.cos(b), math.sin(b), math.cos(g), math.sin(g)
        rm = np.array(
            [
                [cg * ca - cb * sa * sg, cg * sa + cb * ca * sg, sg * sb],
                [-sg * ca - cb * sa * cg, -sg * sa + cb * ca * cg, cg * sb],
                [sb * sa, -sb * ca, cb],
            ]
        )
    rot = np.matmul(model.points.astype(np.float64), rm.T)
    proj = np.zeros((n, n))
    tempden = 0.0
    pix = p.pixel_size
    for kpt in range(model.n_points):
        x, y = rot[kpt, 0], rot[kpt, 1]
        r = float(model.radii[kpt])
        d = float(model.densities[kpt])
        # NO_PROJECT_RADIUS (project_radius=False) is parsed but, as in the
        # reference snapshot, never consumed by the projection kernel.
        if r <= pix:
            i = math.floor(x / pix + n / 2.0 + 0.5)
            j = math.floor(y / pix + n / 2.0 + 0.5)
            if 0 <= i < n and 0 <= j < n:
                proj[i, j] += d
                tempden += d
        else:
            i = math.floor(x / pix + n / 2.0 + 0.5) - p.shift_x
            j = math.floor(y / pix + n / 2.0 + 0.5) - p.shift_y
            irad = int(r / pix) + 1
            rad2 = r * r
            if i < irad or j < irad or i >= n - irad or j >= n - irad:
                continue
            for ii in range(i - irad, i + irad + 1):
                for jj in range(j - irad, j + irad + 1):
                    dist = ((ii - i) ** 2 + (jj - j) ** 2) * pix * pix
                    if dist < rad2:
                        dd = pix * pix * 2 * math.sqrt(rad2 - dist) * d * 3 / (4 * math.pi * r * rad2)
                        proj[ii, jj] += dd
                        tempden += dd
    proj *= model.norm_den / tempden
    return proj


def synthesize_best_map(bp: BestParams, model: Model) -> BestMapResult:
    """Project + convolve at the best parameters (bioem.cpp:1925-1986)."""
    p = best_to_params(bp)
    n = p.n_pixels
    grid = make_ctf_grid(p)
    kernel = build_ctf_bank(p, grid)[0]
    proj = _project_numpy(p, model, np.asarray(bp.orient), bp.use_quaternions)
    conv_f = np.fft.rfft2(proj) * np.conj(kernel)
    sum_c = float(conv_f[0, 0].real)
    conv = np.fft.irfft2(conv_f, s=(n, n))  # = FFTW c2r / N²
    # sumsquareC computed in real space /N⁴ of the unnormalised transform
    # (bioem.cpp:1975-1986) = Σ conv² with normalised inverse.
    ssq = float((conv**2).sum())
    return BestMapResult(conv_map=conv, sum_conv=sum_c, sumsquare_conv=ssq)


def write_best_map(
    bp: BestParams,
    model: Model,
    out: TextIO,
    rng: Optional[np.random.Generator] = None,
) -> BestMapResult:
    """Write the BESTMAP gnuplot file (reference bioem.cpp:2040-2083).

    Values are conv/N²·norm + offset in the reference's convention; our
    conv is already the normalised inverse transform, so just norm+offset.
    """
    res = synthesize_best_map(bp, model)
    n = bp.n_pixels
    # Byte-format parity with the reference (bioem.cpp:2040-2083): values
    # are computed in float32 (Mapconv is myfloat_t) and printed with C++
    # ostream defaults — 6 significant digits, %g-style. Mapconv/norm²
    # equals our normalised inverse transform.
    norm = np.float32(bp.best_norm)
    off = np.float32(bp.best_offset)
    vals = res.conv_map.astype(np.float32) * norm + off
    noise = None
    if bp.with_noise:
        # WITHNOISE parity note: the reference seeds MT19937 from
        # std::time(0) (bioem.cpp:1993-1997), so even two reference runs
        # produce different noise — bit-comparison of WITHNOISE output is
        # impossible BY THE REFERENCE'S OWN DESIGN. What is reproducible is
        # the distribution: MTRand::randNorm draws N(0, stnoise) via
        # polar-form Box-Muller (MersenneTwister.h:343); NumPy's Generator
        # draws the same distribution (and, unlike the reference, can be
        # seeded deterministically by the caller for regression tests).
        rng = rng or np.random.default_rng()
        noise = rng.normal(0.0, bp.noise_std, size=(n, n))
        vals = (vals + noise).astype(np.float32)
    for k in range(n):
        for j in range(n):
            out.write(f"\nMAP {k + bp.ddx} {j + bp.ddy} {vals[k, j]:.6g}")
            if not bp.with_noise and k + bp.ddx < n and j + bp.ddy < n:
                ks, js = k - bp.ddx, j - bp.ddy
                # Reference indexes Mapconv[(k-ddx)·N + j-ddy] without a
                # lower-bound check (UB for negative); we wrap instead.
                out.write(f"\nMAPddx {k} {j} {vals[ks % n, js % n]:.6g}")
        out.write(" \n")
    return res


def bestmap_cc(bp: BestParams, model: Model, ref_map: np.ndarray) -> float:
    """Squared difference between the synthesized map (shifted by ddx/ddy)
    and a reference image (reference BestmapCalcCC, bioem.cpp:2008-2038)."""
    res = synthesize_best_map(bp, model)
    n = bp.n_pixels
    conv = res.conv_map
    cc = 0.0
    for k in range(n):
        for j in range(n):
            kk, jj = k, j
            if k - bp.ddx < 0:
                kk = n - (k - bp.ddx)
            if j - bp.ddy < 0:
                jj = n - (j - bp.ddy)
            if k - bp.ddx >= n:
                kk = k - bp.ddx - n
            if j - bp.ddy >= n:
                jj = j - bp.ddy - n
            kk %= n
            jj %= n
            d = conv[kk, jj] * bp.best_norm - ref_map[k, j]
            cc += d * d
    return cc
