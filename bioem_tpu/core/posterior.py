"""Closed-form log-posterior + displacement integration + streaming LSE.

JAX re-design of reference ``calc_logpro`` / ``calProb`` /
``doRefMapFFT`` (/root/reference/bioem_algorithm.h:18-198) and
``calculateCCFFT`` (/root/reference/bioem.cpp:1435-1459).

Two deliberate departures from the reference implementation — same math,
better hardware mapping:

1. **Displacement evaluation as matmuls, not full inverse FFTs.** The
   reference inverse-FFTs the whole N×N cross-correlation map and reads
   (2·maxD/step+1)² entries. Here the inverse DFT is evaluated *only at the
   displacement lattice* as two small complex matrix products
   ``Re(Wx @ (conv ⊙ conj(img) ⊙ h) @ Wyᵀ)`` with DFT weight matrices — the
   contraction dims are N and N/2+1, so the work is dense matmuls.

2. **Split-precision log-posterior.** ``logpro`` has magnitude ~N²/2·log(…)
   (≈10⁵–10⁶) but only its *variation* across the nuisance grid matters for
   the log-sum-exp. We decompose

       logpro(d) = A·log1p(u_d) + K,   A = (3−N²)/2
       u_d = (2·sref·sC·cc_d − N²·cc_d²) / F0
       F0  = N²·ssref·ssC − ssref·sC² − sref²·ssC     (= firstele at cc=0)
       K   = A·log F0 + (N²/2−2)·log((N²−2)·ForLogProb) − prior

   The huge-but-smooth constant K is computed in float64 (one value per
   (orientation, ctf, image) — a small array next to the D² lattice), while the
   displacement-varying part stays in float32 with *relative* accuracy,
   giving float64-equivalent log(P) at float32 speed. The reference instead
   pays full double precision per displacement (bioem_algorithm.h:42-44).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..defs import MIN_PROB

F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


# ---------------------------------------------------------------------------
# Host-side precomputed constants
# ---------------------------------------------------------------------------

def hermitian_weights(n: int) -> np.ndarray:
    """Column weights for half-spectrum sums (reference bioem.cpp:1892-1914).

    Even N: (1, 2, …, 2, 1); odd N: (1, 2, …, 2)."""
    nf = n // 2 + 1
    h = np.full(nf, 2.0, np.float32)
    h[0] = 1.0
    if n % 2 == 0:
        h[-1] = 1.0
    return h


def displacement_dft_weights(n: int, disp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DFT weight matrices evaluating the inverse FFT at the displacement lattice.

    wx[d, n'] = exp(+2πi·n'·disp_d/N)  (full rows,   shape (D, N))
    wy[d, f]  = exp(+2πi·f·disp_d/N)   (half columns, shape (D, N/2+1))

    Sign matches FFTW's unnormalised c2r backward transform
    (reference bioem.cpp:1458, value normalisation bioem_algorithm.h:163).
    """
    nf = n // 2 + 1
    freq_n = np.arange(n)
    freq_f = np.arange(nf)
    ph_x = 2.0 * np.pi * np.outer(disp.astype(np.float64), freq_n) / n
    ph_y = 2.0 * np.pi * np.outer(disp.astype(np.float64), freq_f) / n
    wx = np.exp(1j * ph_x).astype(np.complex64)
    wy = np.exp(1j * ph_y).astype(np.complex64)
    return wx, wy


# ---------------------------------------------------------------------------
# Device-side kernels
# ---------------------------------------------------------------------------

def convolution_sums(conv_re: jnp.ndarray, conv_im: jnp.ndarray, h: jnp.ndarray, n_pixels: int):
    """sumC and sumsquareC of the convolved projection from its spectrum.

    Reference bioem.cpp:1885-1918: sumC = DC term; sumsquareC = Parseval
    with Hermitian double-counting, divided by N².
    conv_re/conv_im: (..., N, F) float32 → (sumC, ssqC) each (...,) float32.
    """
    sum_c = conv_re[..., 0, 0].astype(F32)
    mag2 = conv_re**2 + conv_im**2
    ssq = jnp.sum(mag2 * h[None, :], axis=(-2, -1)) / jnp.float32(n_pixels * n_pixels)
    return sum_c, ssq


def ctf_prior_term(amp, pha, env, p_static) -> jnp.ndarray:
    """The Gaussian-prior correction subtracted from logpro.

    Copied exactly from reference bioem_algorithm.h:49-67 including the
    sign quirk: ``logpro -= a - b - c`` so the defocus and amplitude terms
    are effectively *added*. f64 per (o, c) — cheap.
    """
    amp = amp.astype(F64)
    pha = pha.astype(F64)
    env = env.astype(F64)
    sb = p_static.sigma_prior_bctf
    sd = p_static.sigma_prior_defocus
    sa = p_static.sigma_prior_amp
    dc = p_static.prior_defocus_center
    ac = p_static.prior_amp_center
    if p_static.use_psf:
        denom = env * env + pha * pha
        env_t = 4.0 * math.pi**2 * env / denom
        pha_t = 4.0 * math.pi**2 * pha / denom
    else:
        env_t = env
        pha_t = pha
    return (
        env_t * env_t / 2.0 / (sb * sb)
        - (pha_t - dc) ** 2 / 2.0 / (sd * sd)
        - (amp - ac) ** 2 / 2.0 / (sa * sa)
    )


def logpro_constants(
    sum_c: jnp.ndarray,  # (O, C) f32
    ssq_c: jnp.ndarray,  # (O, C) f32
    sum_ref: jnp.ndarray,  # (I,) f32
    ssq_ref: jnp.ndarray,  # (I,) f32
    prior: jnp.ndarray,  # (O, C) f64
    ntot: float,
    images_normalized: bool = False,
):
    """F0 and K of the split-precision decomposition. Returns f64 (O, C, I).

    log(F0) — the only f64 transcendental on a per-(o,c,i) array — is
    decomposed so the emulated f64 logs run on (I,) and (O,C) arrays only:

        F0 = ssr·ssc·(g − h),  g = ntot − sc²/ssc,  h = sr²/ssr
        log F0 = log ssr + log ssc + log g + log1p(−h/g)

    With ``images_normalized`` (the default ingest path: per-image mean
    removed, map.cpp:830-845) sr ≈ 0, so h/g ≲ 1e-7 and the per-(o,c,i)
    log1p correction is exact in f32 (absolute error ≤ eps·|h/g| ≪ the
    4e-8 needed for 1e-3-accurate a_coef·log F0 at N=224). NO_MAP_NORM
    images keep the correction in f64 — a static, trace-time choice."""
    sc = sum_c.astype(F64)[:, :, None]
    ssc = ssq_c.astype(F64)[:, :, None]
    sr = sum_ref.astype(F64)[None, None, :]
    ssr = ssq_ref.astype(F64)[None, None, :]
    ntot = jnp.float64(ntot)
    a_coef = (3.0 - ntot) * 0.5
    forlog = ssc * ntot - sc * sc
    if images_normalized:
        g = forlog / ssc  # (O, C, 1)
        h = sr * sr / ssr  # (1, 1, I)
        f0 = ssr * ssc * (g - h)
        ratio = h / g  # (O, C, I) — muls only, no per-(o,c,i) transcendental
        corr = jnp.log1p(-(ratio.astype(F32))).astype(F64)
        log_f0 = jnp.log(ssr) + jnp.log(ssc) + jnp.log(g) + corr
    else:
        # DC-capable reference point: F0 = ssr·ssc·(g−h) goes NEGATIVE for
        # DC-dominated (never-normalised TEXT) images — g−h = ntot −
        # sc²/ssc − sr²/ssr has no sign guarantee, only the full firstele
        # does (Gram determinant). Use F0' = ntot·ssr·ssc > 0 and fold the
        # −ssr·sc² − sr²·ssc terms into the (f64) u of displacement_lse.
        f0 = jnp.broadcast_to(
            ntot * ssr * ssc, (sc.shape[0], sc.shape[1], sr.shape[2])
        )
        log_f0 = jnp.log(ntot) + jnp.log(ssr) + jnp.log(ssc)
    k = (
        a_coef * log_f0
        + (ntot * 0.5 - 2.0) * jnp.log((ntot - 2.0) * forlog)
        - prior[:, :, None]
    )
    return f0, k


def displacement_cc(
    conv_re: jnp.ndarray,  # (O, C, N, F) f32
    conv_im: jnp.ndarray,
    img_re: jnp.ndarray,  # (I, N, F) f32 — conj(rfft2(img))·h/N² prefolded
    img_im: jnp.ndarray,
    wx_re: jnp.ndarray,  # (D, N) f32
    wx_im: jnp.ndarray,
    wy_re: jnp.ndarray,  # (D, F) f32
    wy_im: jnp.ndarray,
) -> jnp.ndarray:
    """Cross-correlation values at the displacement lattice.

    cc[o,c,i,dx,dy] = Re( wx[dx] @ (conv[o,c] ⊙ img_fc[i]) @ wy[dy]ᵀ )

    Equivalent to reference calculateCCFFT + the /N² normalisation of
    bioem_algorithm.h:163, but evaluated only at the D² lattice points via
    matmuls. Complex arithmetic is hand-split into real float32 operations
    whose contraction dims are the N rows and N/2+1 columns. Returns
    (O,C,I,D,D) float32.
    """
    # product P = conv ⊙ img_fc (complex, split)
    with jax.named_scope("cc_product"):
        p_re = conv_re[:, :, None] * img_re[None, None] - conv_im[:, :, None] * img_im[None, None]
        p_im = conv_re[:, :, None] * img_im[None, None] + conv_im[:, :, None] * img_re[None, None]
    # T1 = wx @ P  (contract rows n). precision=HIGHEST keeps full f32: a
    # GPU's default f32 matmul runs in TF32, which loses ~3 decimal digits
    # of cc, enough to move the displacement argmax.
    hi = jax.lax.Precision.HIGHEST
    ein = partial(jnp.einsum, precision=hi)
    with jax.named_scope("cc_stage1"):
        t1_re = ein("dn,ocinf->ocidf", wx_re, p_re) - ein("dn,ocinf->ocidf", wx_im, p_im)
        t1_im = ein("dn,ocinf->ocidf", wx_re, p_im) + ein("dn,ocinf->ocidf", wx_im, p_re)
    # cc = Re(T1 @ wyᵀ)  (contract cols f)
    with jax.named_scope("cc_stage2"):
        cc = ein("ef,ocidf->ocide", wy_re, t1_re) - ein("ef,ocidf->ocide", wy_im, t1_im)
    return cc.astype(F32)


def refine_varying_max(cc_star, sum_c, sum_ref, f0, ntot):
    """f64 re-evaluation of the varying-part max A·log1p(u*) at the argmax
    displacement (f32-u path formula: u = (2·sr·sC·cc − N²·cc²)/F0).

    The max's ABSOLUTE error enters log P directly (log Σexp(v) =
    m + log Σexp(v−m) for any m), and a_coef ≈ −N²/2 amplifies any f32
    rounding of log1p(u*) by ~25k at N=224. This one f64 log1p per
    (o, c, i) — the same per-(o,c,i) cost class as the K constant —
    removes that from the posterior's absolute level. Returns f64
    (merge_block upcasts m anyway)."""
    cc64 = cc_star.astype(F64)
    u = (
        2.0 * sum_ref.astype(F64)[None, None, :]
        * sum_c.astype(F64)[:, :, None] * cc64
        - jnp.float64(ntot) * cc64 * cc64
    ) / f0
    a_coef = jnp.float64((3.0 - ntot) * 0.5)
    return a_coef * jnp.log1p(u)


def displacement_lse(
    cc: jnp.ndarray,  # (O, C, I, D, D) f32
    sum_c: jnp.ndarray,  # (O, C) f32
    sum_ref: jnp.ndarray,  # (I,) f32
    f0: jnp.ndarray,  # (O, C, I) f64
    ntot: float,
    f32_u: bool = True,
    ssq_c: jnp.ndarray = None,  # (O, C) f32 — required when f32_u=False
    ssq_ref: jnp.ndarray = None,  # (I,) f32
):
    """Max + sum-exp of A·log1p(u_d) over the displacement grid.

    Returns (m, sumexp, d_star, cc_star): per-(o,c,i) float32 max of the
    varying part, Σexp(V−m), flat argmax displacement index (reference
    sweep order → same tie-breaking as bioem_algorithm.h:156-197), and the
    cc value at the argmax (needed for the analytic norm/offset).

    ``f32_u=False`` pairs with logpro_constants' DC-capable reference
    F0 = ntot·ssr·ssc and evaluates the FULL varying part in f64 (like the
    reference's double calc_logpro on float cc inputs,
    bioem_algorithm.h:18-70):

        u = (2·sr·sc·cc − ntot·cc² − ssr·sc² − sr²·ssc) / F0

    so firstele = F0·(1+u) with u ∈ (−1, 0] exactly when the Gram
    determinant is; for DC-dominated unnormalised images the f32 split
    path rounds u below −1 → NaN. The engine selects the branch from the
    same data-driven gate as logpro_constants.
    """
    o, c, i, d1, d2 = cc.shape
    a_coef = jnp.float32((3.0 - ntot) * 0.5)
    # One flat displacement axis: a single reduction per (o, c, i).
    cc_flat = cc.reshape(o, c, i, d1 * d2)
    if f32_u:
        sc = sum_c[:, :, None, None]
        sr = sum_ref[None, None, :, None]
        f0_32 = f0.astype(F32)[:, :, :, None]
        u = (
            2.0 * sr * sc * cc_flat - jnp.float32(ntot) * cc_flat * cc_flat
        ) / f0_32
        v_flat = a_coef * jnp.log1p(u)  # (O,C,I,D²)
        m = jnp.max(v_flat, axis=-1)
        d_star = jnp.argmax(v_flat, axis=-1).astype(I32)
        sumexp = jnp.sum(jnp.exp(v_flat - m[..., None]), axis=-1)
        cc_star = jnp.take_along_axis(cc_flat, d_star[..., None], axis=-1)[..., 0]
        # Absolute-accuracy repair: recompute the max term at the argmax in
        # f64 (one log1p per (o,c,i) — same cost class as the K constant).
        # log Σexp(v) = m + log Σexp(v−m) holds for ANY m, so substituting
        # the f64 value corrects the absolute f32 rounding exactly at the
        # term that sets log P's absolute level, while the f32 relative
        # differences are untouched. sumexp above was computed against the
        # raw f32 max — the identity absorbs the difference.
        m = refine_varying_max(cc_star, sum_c, sum_ref, f0, ntot)
        return m, sumexp, d_star, cc_star
    else:
        cc64 = cc_flat.astype(F64)
        sc = sum_c.astype(F64)[:, :, None, None]
        sr = sum_ref.astype(F64)[None, None, :, None]
        ssc = ssq_c.astype(F64)[:, :, None, None]
        ssr = ssq_ref.astype(F64)[None, None, :, None]
        num = (
            2.0 * sr * sc * cc64
            - jnp.float64(ntot) * cc64 * cc64
            - ssr * sc * sc
            - sr * sr * ssc
        )
        u = num / f0[:, :, :, None]
        v_flat = (a_coef.astype(F64) * jnp.log1p(u)).astype(F32)
    m = jnp.max(v_flat, axis=-1)
    d_star = jnp.argmax(v_flat, axis=-1).astype(I32)
    sumexp = jnp.sum(jnp.exp(v_flat - m[..., None]), axis=-1)
    cc_star = jnp.take_along_axis(cc_flat, d_star[..., None], axis=-1)[..., 0]
    return m, sumexp, d_star, cc_star


# ---------------------------------------------------------------------------
# Streaming posterior state
# ---------------------------------------------------------------------------

class PosteriorState(NamedTuple):
    """Per-image streaming accumulator (reference bioem_Probability,
    map.h:116-172): online log-sum-exp pair + argmax parameter tuple."""

    total: jnp.ndarray  # (I,) f64
    const: jnp.ndarray  # (I,) f64 — running max logpro (= Constoadd)
    best_orient: jnp.ndarray  # (I,) i32
    best_conv: jnp.ndarray  # (I,) i32
    best_cent_x: jnp.ndarray  # (I,) i32 — already negated, as reported
    best_cent_y: jnp.ndarray  # (I,) i32
    best_norm: jnp.ndarray  # (I,) f64
    best_mu: jnp.ndarray  # (I,) f64
    ang_total: Optional[jnp.ndarray] = None  # (I, n_orient) f64
    ang_const: Optional[jnp.ndarray] = None  # (I, n_orient) f64


def init_state(n_img: int, n_orient: int, write_angles: bool) -> PosteriorState:
    """Reference bioem.cpp:681-699: Total ← 0, Constoadd ← MIN_PROB."""
    # Distinct buffers per field: the state is donated into the jitted block
    # step, and XLA rejects donating one buffer through several arguments.
    return PosteriorState(
        total=jnp.zeros((n_img,), F64),
        const=jnp.full((n_img,), MIN_PROB, F64),
        best_orient=jnp.zeros((n_img,), I32),
        best_conv=jnp.zeros((n_img,), I32),
        best_cent_x=jnp.zeros((n_img,), I32),
        best_cent_y=jnp.zeros((n_img,), I32),
        best_norm=jnp.zeros((n_img,), F64),
        best_mu=jnp.zeros((n_img,), F64),
        ang_total=jnp.zeros((n_img, n_orient), F64) if write_angles else None,
        ang_const=jnp.full((n_img, n_orient), MIN_PROB, F64) if write_angles else None,
    )


def merge_block(
    state: PosteriorState,
    m: jnp.ndarray,  # (O, C, I) f32 — varying-part max
    sumexp: jnp.ndarray,  # (O, C, I) f32
    d_star: jnp.ndarray,  # (O, C, I) i32
    cc_star: jnp.ndarray,  # (O, C, I) f32
    k_const: jnp.ndarray,  # (O, C, I) f64
    sum_c: jnp.ndarray,  # (O, C) f32
    ssq_c: jnp.ndarray,  # (O, C) f32
    sum_ref: jnp.ndarray,  # (I,) f32
    disp_vals: jnp.ndarray,  # (D,) i32 signed displacements in sweep order
    orient_offset: jnp.ndarray,  # scalar i32 — global index of block's first orientation
    ntot: float,
    n_disp: int,
    ang_offset: Optional[jnp.ndarray] = None,  # offset into the (shard-local)
    # per-angle state slabs; equals orient_offset on a single device, or the
    # block's position within this orientation shard under shard_map
) -> PosteriorState:
    """Fold one (orientation-block × ctf-bank × image) result into the state.

    Equivalent to the reference's sequential calProb loop
    (bioem_algorithm.h:94-141) but merged hierarchically: exact same
    log-sum-exp value, same argmax under the strict-``>`` first-occurrence
    rule because (o, c) blocks arrive in reference iteration order.
    """
    o, c, i = m.shape
    logmax = k_const + m.astype(F64)  # (O, C, I) f64 — per-(o,c) max logpro

    lm = logmax.reshape(o * c, i)
    block_max = jnp.max(lm, axis=0)  # (I,) f64
    oc_star = jnp.argmax(lm, axis=0).astype(I32)  # first occurrence
    diff = (lm - block_max[None, :]).astype(F32)
    # −inf − −inf = NaN when a shard's block is fully masked (padding) —
    # such lanes contribute zero, not NaN.
    ex = jnp.exp(diff)
    ex = jnp.where(jnp.isnan(diff), 0.0, ex)
    block_sum = jnp.sum(sumexp.reshape(o * c, i) * ex, axis=0).astype(F64)  # (I,)

    new_const = jnp.maximum(state.const, block_max)
    new_total = state.total * jnp.exp(state.const - new_const) + block_sum * jnp.exp(
        block_max - new_const
    )

    upd = block_max > state.const  # strict >, reference bioem_algorithm.h:96

    # Gather argmax parameters
    img_idx = jnp.arange(i)
    o_star = oc_star // c
    c_star = oc_star % c
    sc_b = sum_c[o_star, c_star].astype(F64)  # (I,)
    ssc_b = ssq_c[o_star, c_star].astype(F64)
    cc_b = cc_star[o_star, c_star, img_idx].astype(F64)
    d_b = d_star[o_star, c_star, img_idx]
    dx_b = disp_vals[d_b // n_disp]
    dy_b = disp_vals[d_b % n_disp]
    sr = sum_ref.astype(F64)
    ntot64 = jnp.float64(ntot)
    denom = sc_b * sc_b - ssc_b * ntot64
    norm_b = -(-sc_b * sr + ntot64 * cc_b) / denom  # bioem_algorithm.h:106-108
    mu_b = -(-sc_b * cc_b + ssc_b * sr) / denom  # bioem_algorithm.h:109-111

    state = state._replace(
        total=new_total,
        const=new_const,
        best_orient=jnp.where(upd, orient_offset + o_star.astype(I32), state.best_orient),
        best_conv=jnp.where(upd, c_star.astype(I32), state.best_conv),
        best_cent_x=jnp.where(upd, -dx_b, state.best_cent_x),
        best_cent_y=jnp.where(upd, -dy_b, state.best_cent_y),
        best_norm=jnp.where(upd, norm_b, state.best_norm),
        best_mu=jnp.where(upd, mu_b, state.best_mu),
    )

    if state.ang_total is not None:
        # Per-(image, orientation) accumulation (bioem_algorithm.h:130-141),
        # merged over the ctf axis then streamed into the global slice.
        if ang_offset is None:
            ang_offset = orient_offset
        ang_max = jnp.max(logmax, axis=1)  # (O, I)
        adiff = (logmax - ang_max[:, None, :]).astype(F32)
        aex = jnp.where(jnp.isnan(adiff), 0.0, jnp.exp(adiff))
        ang_sum = jnp.sum(sumexp * aex, axis=1).astype(F64)  # (O, I)

        sl_tot = jax.lax.dynamic_slice_in_dim(state.ang_total, ang_offset, o, axis=1)
        sl_con = jax.lax.dynamic_slice_in_dim(state.ang_const, ang_offset, o, axis=1)
        am = ang_max.T  # (I, O)
        asum = ang_sum.T
        new_c = jnp.maximum(sl_con, am)
        new_t = sl_tot * jnp.exp(sl_con - new_c) + asum * jnp.exp(am - new_c)
        state = state._replace(
            ang_total=jax.lax.dynamic_update_slice_in_dim(
                state.ang_total, new_t, ang_offset, axis=1
            ),
            ang_const=jax.lax.dynamic_update_slice_in_dim(
                state.ang_const, new_c, ang_offset, axis=1
            ),
        )
    return state


def merge_across_orient(state: PosteriorState, axis_name: str) -> PosteriorState:
    """Collective log-sum-exp + argmax merge over the orientation mesh axis.

    JAX replacement for the reference's MPI three-phase reduction
    (/root/reference/bioem.cpp:909-1044): Allreduce-MAX of per-image
    constants, local rescale, SUM-reduce of shifted totals, and point-to-
    point shipping of the argmax tuple — here a pmax + psum pair plus a
    lowest-owner-wins selection that reproduces the sequential strict-``>``
    tie-breaking (earlier orientations win ties).

    Per-angle slabs are orientation-sharded (each orientation owned by one
    shard) so they need no collective.
    """
    const_max = jax.lax.pmax(state.const, axis_name)
    total = jax.lax.psum(state.total * jnp.exp(state.const - const_max), axis_name)

    idx = jax.lax.axis_index(axis_name)
    big = jnp.int32(2**30)
    owner = jax.lax.pmin(
        jnp.where(state.const >= const_max, idx, big), axis_name
    )
    mine = owner == idx

    def pick(x):
        zero = jnp.zeros_like(x)
        return jax.lax.psum(jnp.where(mine, x, zero), axis_name)

    return state._replace(
        total=total,
        const=const_max,
        best_orient=pick(state.best_orient),
        best_conv=pick(state.best_conv),
        best_cent_x=pick(state.best_cent_x),
        best_cent_y=pick(state.best_cent_y),
        best_norm=pick(state.best_norm),
        best_mu=pick(state.best_mu),
    )
