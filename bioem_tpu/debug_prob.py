"""Per-evaluation log-posterior dump (reference DEBUG_PROB analogue).

The reference, compiled with ``-DDEBUG_PROB`` (/root/reference/include/defs.h:52),
prints every (iRefMap, iOrient, iConv, disx, disy, cc, logpro) evaluation from
both its CPU and CUDA paths (/root/reference/bioem_algorithm.h:88-128,
/root/reference/bioem_cuda.cu:308-313) so the two implementations can be
diffed line-by-line at any problem size — the debugging story the oracle
tests cannot provide at production shapes.

JAX analogue: :func:`dump_logpro` recomputes the FULL per-displacement log
posterior of one selected image through the engine's own projection,
convolution and displacement-matmul pieces and its split-precision
decomposition, and returns/writes it as reference-style text lines.
``tools/diff_prob_dump.py`` diffs two dumps (e.g. of two engines built with
different block sizes, or of two devices).

Env gating (read by the CLI after the main run):

* ``BIOEM_TPU_DEBUG_PROB`` — image index to dump.
* ``BIOEM_TPU_DEBUG_PROB_FILE`` — output path (default ``debug_prob.txt``).
"""

from __future__ import annotations

import re
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.posterior import (
    convolution_sums,
    ctf_prior_term,
    displacement_cc,
    logpro_constants,
)

F32 = jnp.float32
F64 = jnp.float64


def _block_logpro(engine, banks, angles, img_re, img_im, sref, ssref):
    """Full (O, C, D, D) f64 logpro of one image for one orientation block.

    Mirrors engine._block_step's math but keeps every displacement value
    instead of reducing: logpro = K + a_coef·log1p(u), the engine's
    split-precision decomposition (core/posterior.py docstring)."""
    p = engine.p
    n = p.n_pixels
    ntot = p.n_total_pixels
    pr, pi = engine._project_block(banks, angles)
    prior = ctf_prior_term(banks.amp, banks.pha, banks.env, p)  # (C,) f64
    conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
    conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
    sum_c, ssq_c = convolution_sums(conv_re, conv_im, banks.h, n)
    cc = displacement_cc(
        conv_re, conv_im, img_re, img_im,
        banks.wx_re, banks.wx_im, banks.wy_re, banks.wy_im,
    )

    prior_oc = jnp.broadcast_to(prior[None, :], sum_c.shape)
    f0, k = logpro_constants(
        sum_c, ssq_c, sref, ssref, prior_oc, ntot,
        images_normalized=engine._f32_corr_ok,
    )
    a_coef = (3.0 - ntot) * 0.5
    cc_i = cc[:, :, 0]  # (O, C, D, D)
    if engine._f32_corr_ok:
        sc = sum_c[:, :, None, None]
        sr = sref.astype(F32)[0]
        u = (
            2.0 * sr * sc * cc_i - jnp.float32(ntot) * cc_i * cc_i
        ) / f0.astype(F32)[:, :, 0, None, None]
        # The engine's f64 repair of the ARGMAX term (refine_varying_max)
        # is a property of the merged max, not of per-evaluation values,
        # so it has no mirror here — dump-vs-output totals agree to the
        # f32 rounding floor (~1e-7·|v|).
        v = jnp.float32(a_coef) * jnp.log1p(u)
        logpro = k[:, :, 0, None, None] + v.astype(F64)
    else:
        cc64 = cc_i.astype(F64)
        sc = sum_c.astype(F64)[:, :, None, None]
        sr = sref.astype(F64)[0]
        ssc = ssq_c.astype(F64)[:, :, None, None]
        ssr = ssref.astype(F64)[0]
        num = (
            2.0 * sr * sc * cc64
            - jnp.float64(ntot) * cc64 * cc64
            - ssr * sc * sc
            - sr * sr * ssc
        )
        u = num / f0[:, :, 0, None, None]
        v = jnp.float64(a_coef) * jnp.log1p(u)
        logpro = k[:, :, 0, None, None] + v
    return logpro, cc_i.astype(F64)


def dump_logpro(engine, image_index: int, banks=None):
    """(logpro, cc) arrays of shape (n_orient, n_ctf, D, D) float64 for one
    image — every posterior evaluation the engine integrates over."""
    if banks is None:
        banks = engine.banks
    if not 0 <= image_index < engine.n_img:
        raise ValueError(
            f"image index {image_index} outside [0, {engine.n_img})"
        )
    i = image_index
    img_re = banks.img_re[i : i + 1]
    img_im = banks.img_im[i : i + 1]
    sref = banks.sum_ref[i : i + 1]
    ssref = banks.ssq_ref[i : i + 1]

    step = jax.jit(partial(_block_logpro, engine))
    out_lp, out_cc = [], []
    nblk = engine.ang_blocks.shape[0]
    for b in range(nblk):
        lp, cc = step(banks, engine.ang_blocks[b], img_re, img_im, sref, ssref)
        out_lp.append(np.asarray(lp))
        out_cc.append(np.asarray(cc))
    lp = np.concatenate(out_lp, axis=0)[: engine.n_orient]
    cc = np.concatenate(out_cc, axis=0)[: engine.n_orient]
    return lp, cc


def write_dump(path: str, image_index: int, logpro, cc, disp) -> None:
    """Reference-format dump lines (bioem_algorithm.h:89-92):

    ``Prob: iRefMap I, iOrient O, iConv C, disx X, disy Y, value V, logpro L``
    """
    disp = np.asarray(disp)
    n_o, n_c, d, _ = logpro.shape
    with open(path, "w") as f:
        for o in range(n_o):
            for c in range(n_c):
                for ix in range(d):
                    for iy in range(d):
                        f.write(
                            f"Prob: iRefMap {image_index}, iOrient {o}, "
                            f"iConv {c}, disx {disp[ix]}, disy {disp[iy]}, "
                            f"value {cc[o, c, ix, iy]:.10g}, "
                            f"logpro {logpro[o, c, ix, iy]:.10g}\n"
                        )


_LINE = re.compile(
    r"Prob: iRefMap (-?\d+), iOrient (-?\d+), iConv (-?\d+), "
    r"disx (-?\d+), disy (-?\d+), value (\S+), logpro (\S+)"
)


def read_dump(path: str) -> dict:
    """{(iRefMap, iOrient, iConv, disx, disy): (value, logpro)}"""
    out = {}
    with open(path) as f:
        for line in f:
            m = _LINE.match(line.strip())
            if m:
                key = tuple(int(x) for x in m.groups()[:5])
                out[key] = (float(m.group(6)), float(m.group(7)))
    return out


def diff_dumps(a: dict, b: dict):
    """Compare two parsed dumps. Returns (max_dlogpro, max_dcc, worst_key,
    n_common, n_only_a, n_only_b)."""
    common = a.keys() & b.keys()
    worst = (0.0, 0.0, None)
    for k in common:
        dl = abs(a[k][1] - b[k][1])
        dc = abs(a[k][0] - b[k][0])
        if dl > worst[0]:
            worst = (dl, dc, k)
    return (
        worst[0],
        max((abs(a[k][0] - b[k][0]) for k in common), default=0.0),
        worst[2],
        len(common),
        len(a.keys() - b.keys()),
        len(b.keys() - a.keys()),
    )


def maybe_dump_from_env(engine) -> Optional[str]:
    """CLI hook: honour BIOEM_TPU_DEBUG_PROB after the main run."""
    import os

    idx = os.environ.get("BIOEM_TPU_DEBUG_PROB")
    if idx is None:
        return None
    path = os.environ.get("BIOEM_TPU_DEBUG_PROB_FILE", "debug_prob.txt")
    i = int(idx)
    lp, cc = dump_logpro(engine, i)
    write_dump(path, i, lp, cc, np.asarray(engine.disp))
    print(f"DEBUG_PROB dump ({lp.size} evaluations) written to: {path}")
    return path
