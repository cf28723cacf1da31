"""Continuous MAP refinement of the maximizing parameters via autodiff.

The reference reports the *grid* argmax — orientation, CTF index,
displacement, analytic norm/offset (/root/reference/bioem.cpp:1141-1222) —
and stops there: its accuracy is bounded by the grid spacing. Because this
framework's forward model is a pure JAX function, the single-point log
posterior ``calc_logpro`` (/root/reference/bioem_algorithm.h:18-70) is
differentiable in the **continuous** nuisance parameters, so the grid
argmax can be polished off-grid. The C++/CUDA reference has no analogue of
this capability.

The refinement objective is a *smooth surrogate* of the grid engine's
forward model — same physics, with the two non-smooth discretisation
artifacts removed:

* **Sub-pixel projection**: the grid engine snaps every rotated point to
  its nearest pixel (``fourier_prologue``; reference bioem.cpp:1715-1741),
  a staircase in orientation. The surrogate places each point at its exact
  continuous position via the Fourier shift phase — the snapped model's
  smooth limit. Each sphere keeps its pixel-sampled footprint stencil
  (it does not move with sub-pixel shifts; only its center phase does).
* **Clean CTF radial response**: the reference's Fourier-space CTF writer
  has a row-mirror overwrite quirk (param.cpp:1548-1569, replayed by
  ``core.ctf._ctf_row_map`` for bit parity) that makes one frequency row
  discontinuous. The surrogate uses the intended Hermitian row frequency
  ``min(i, N−i)``.
* Out-of-bounds density masking is omitted (non-smooth); the engine
  already warns when projections leave the grid.

Displacements enter through ``exp(i·2π(n·dx + f·dy)/N)`` factors and are
already continuous. Orientation is parameterised as a tangent-space
rotation ``R = exp([ω]×)·R₀`` (Rodrigues, sinc-safe at ω=0) around the
grid-argmax rotation R₀ — no quaternion normalisation constraints and
valid for Euler- and quaternion-mode grids alike.

**Optimizer: multi-start damped Newton.** The parameter space is only
8-dimensional (ω, d, CTF pha/env/amp — amp gated off unless
``refine_ctf_amp``), so the exact Hessian via
``jax.hessian`` is cheap and a Levenberg-damped Newton iteration is
affine-invariant — no learning rates to tune on a surface whose
curvature spans orders of magnitude across (rotation, displacement, CTF)
axes. The posterior surface ripples at the pixel scale of projected point
motion, so a single gradient flow from the grid seed can drain into a
sidelobe (first-order methods measurably do, even when a monotone uphill
path to the true peak exists — the flow crosses a curved separatrix).
The standard cure is multi-start: Newton runs from the seed plus
``n_starts−1`` jittered starts at grid-cell scale, all images × starts
batched in one vmap, and the best final log-posterior
wins. Starts are accept/reject monotone, so the winner is ≥ the seed
objective by construction.

Heavy tensors (projection phases, spectra) stay float32; the five scalar
moments and ``calc_logpro`` are evaluated in float64, mirroring the
engine's split-precision policy (core/posterior.py module docstring).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import defs
from .core.orientations import rotation_matrices
from .core.projection import fourier_epilogue

F32 = jnp.float32
F64 = jnp.float64

# Lower bound for the refined CTF B-envelope (Å²-scaled Fourier damping):
# keeps exp(-r²·env/2) a decaying filter under refinement.
ENV_FLOOR = 1e-8


# ---------------------------------------------------------------------------
# Smooth forward-model pieces
# ---------------------------------------------------------------------------

def exp_so3(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation exp([ω]×), smooth at ω = 0 via sinc forms.

    sin(θ)/θ = sinc(θ/π) and (1−cos θ)/θ² = ½·sinc(θ/2π)² — both are
    analytic. The tiny bias inside the sqrt keeps the θ(ω) gradient finite
    at the ω = 0 seed (the sinc factors' chain rule then cancels it to the
    correct limit, e.g. ∂a/∂(ω·ω) → −1/6)."""
    theta = jnp.sqrt(jnp.sum(omega * omega) + 1e-24)
    a = jnp.sinc(theta / jnp.pi)  # sin θ / θ
    half = theta / (2.0 * jnp.pi)
    b = 0.5 * jnp.sinc(half) * jnp.sinc(half)  # (1 − cos θ)/θ²
    wx, wy, wz = omega[0], omega[1], omega[2]
    k = jnp.array([[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]], omega.dtype)
    eye = jnp.eye(3, dtype=omega.dtype)
    # HIGHEST: a GPU's default f32 matmul is TF32 — its ~1e-3 relative
    # error on a rotation matrix would swamp the sub-pixel polish this
    # module exists for.
    kk = jnp.matmul(k, k, precision=jax.lax.Precision.HIGHEST)
    return eye + a * k + b * kk


def smooth_projection_phases(
    n: int,
    pixel_size: float,
    shift_x: int,
    shift_y: int,
    rotmat: jnp.ndarray,  # (3, 3)
    points: jnp.ndarray,  # (P, 3) group-layout points (engine banks order)
    radii: jnp.ndarray,  # (P,)
):
    """Continuous (θx, θy) per point — the smooth limit of the grid
    engine's ``fourier_prologue`` pixel snap ``floor(x/pix + N/2 + 0.5)``
    (reference bioem.cpp:1715-1741). The SHIFT_X/Y offsets apply to
    large-radius points exactly as in the snapped path."""
    pix = jnp.asarray(pixel_size, F32)
    # HIGHEST: see exp_so3 — reduced-precision matmuls break sub-pixel
    # accuracy.
    rot = jnp.matmul(
        points, rotmat.T.astype(points.dtype),
        precision=jax.lax.Precision.HIGHEST,
    )
    half = jnp.asarray(n, F32) / 2.0
    i_c = rot[:, 0] / pix + half
    j_c = rot[:, 1] / pix + half
    small = radii <= pix
    i0 = jnp.where(small, i_c, i_c - shift_x)
    j0 = jnp.where(small, j_c, j_c - shift_y)
    two_pi_n = jnp.asarray(2.0 * math.pi / n, F32)
    return -two_pi_n * i0, -two_pi_n * j0


def smooth_ctf_spectrum(
    n: int,
    pixel_size: float,
    use_psf: bool,
    amp: jnp.ndarray,
    pha: jnp.ndarray,
    env: jnp.ndarray,
    cos_n: Optional[jnp.ndarray] = None,  # (N, N) PSF-mode DFT tables
    sin_n: Optional[jnp.ndarray] = None,
    cos_f: Optional[jnp.ndarray] = None,  # (F, N)
    sin_f: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """(N, F) real CTF/PSF transfer function, differentiable in
    (amp, pha, env).

    CTF mode: the reference formula (param.cpp:1546-1574) with the clean
    Hermitian row frequency min(i, N−i) instead of the row-mirror quirk,
    DC-normalised. PSF mode: real-space kernel (param.cpp:1474-1499),
    sum-normalised; its spectrum is real by the kernel's i→N−i symmetry
    and is evaluated with the supplied cosine/sine DFT tables."""
    amp = amp.astype(F32)
    pha = pha.astype(F32)
    env = env.astype(F32)

    def ctf_value(radsq):
        return jnp.exp(-radsq * env / 2.0) * (
            -amp * jnp.cos(radsq * pha / 2.0)
            - jnp.sqrt(1.0 - amp * amp) * jnp.sin(radsq * pha / 2.0)
        )

    nf = n // 2 + 1
    if not use_psf:
        idx = jnp.arange(n, dtype=F32)
        ri = jnp.minimum(idx, n - idx)
        j = jnp.arange(nf, dtype=F32)
        radsq = (ri[:, None] ** 2 + j[None, :] ** 2) / jnp.asarray(
            float(n * n) * pixel_size * pixel_size, F32
        )
        vals = ctf_value(radsq)
        return vals / vals[0, 0]
    idx = jnp.arange(n)
    r = jnp.where(idx < nf, idx, n - idx).astype(F32)
    radsq = (r[:, None] ** 2 + r[None, :] ** 2) * jnp.asarray(
        pixel_size * pixel_size, F32
    )
    kern = ctf_value(radsq)
    kern = kern / jnp.sum(kern)
    # Real spectrum of the symmetric kernel: C kern C_Fᵀ − S kern S_Fᵀ.
    hi = jax.lax.Precision.HIGHEST
    return (
        jnp.matmul(cos_n, jnp.matmul(kern, cos_f.T, precision=hi), precision=hi)
        - jnp.matmul(sin_n, jnp.matmul(kern, sin_f.T, precision=hi), precision=hi)
    )


def _cc_at(
    p_re: jnp.ndarray,  # (N, F) f64 conv ⊙ img_fc product, split
    p_im: jnp.ndarray,
    n: int,
    d: jnp.ndarray,  # (2,) f64 continuous displacement (pixels)
) -> jnp.ndarray:
    """Re(Σ P·e^{i2π(n'·dx + f·dy)/N}) — the cross-correlation at a
    continuous displacement (cf. displacement_cc's lattice matmuls).

    Row frequencies must be SIGNED for non-integer d: with raw 0..N−1
    indices the interpolant still passes through the correct integer-shift
    values (e^{i2πkd/N} is k-periodic at integer d) but oscillates at the
    Nyquist scale between them — a subpixel-shifted real image (the
    simulator-closure test, or any real particle) would drive the Newton
    polish into wrap artifacts. Signed frequencies give the band-limited
    interpolation, i.e. the true continuous cross-correlation."""
    nf = n // 2 + 1
    kx = (jnp.arange(n, dtype=F64) + n // 2) % n - n // 2
    phx = 2.0 * jnp.pi * kx * d[0] / n
    phy = 2.0 * jnp.pi * jnp.arange(nf, dtype=F64) * d[1] / n
    cx, sx = jnp.cos(phx), jnp.sin(phx)
    cy, sy = jnp.cos(phy), jnp.sin(phy)
    hi = jax.lax.Precision.HIGHEST
    t_re = jnp.matmul(cx, p_re, precision=hi) - jnp.matmul(sx, p_im, precision=hi)
    t_im = jnp.matmul(cx, p_im, precision=hi) + jnp.matmul(sx, p_re, precision=hi)
    return jnp.dot(cy, t_re, precision=hi) - jnp.dot(sy, t_im, precision=hi)


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------

def _logpro_smooth(theta, consts, static):
    """Single-point log posterior (reference calc_logpro,
    bioem_algorithm.h:18-70, priors included) at continuous parameters.

    theta: dict(omega (3,), d (2,), dctf (2,)) f64 perturbations around the
    per-image seed in ``consts``; ``static`` carries trace-time constants
    and the model/stencil banks shared by all images."""
    n = static["n"]
    ntot = jnp.asarray(static["ntot"], F64)
    rot = jnp.matmul(
        exp_so3(theta["omega"].astype(F32)), consts["rot0"],
        precision=jax.lax.Precision.HIGHEST,
    )
    th_x, th_y = smooth_projection_phases(
        n, static["pixel_size"], static["shift_x"], static["shift_y"],
        rot, static["points"], static["radii"],
    )
    proj_re, proj_im = fourier_epilogue(
        static["fspec"], th_x, th_y, static["dens"], static["norm_den"],
        static["st_re"], static["st_im"], static["st_sums"],
        signed_rows=True,  # continuous positions need signed frequencies
    )
    pha = consts["pha0"] + theta["dctf"][0].astype(F32)
    # Clamp the refined envelope to stay physical: env <= 0 would turn
    # exp(-r²·env/2) into an exponentially growing high-frequency amplifier
    # and the symmetric Gaussian prior would not prevent the optimizer from
    # settling on that noise-fitting optimum.
    env = jnp.maximum(consts["env0"] + theta["dctf"][1].astype(F32), ENV_FLOOR)
    # Amplitude lives in [0, 1]: the CTF mixes amp·cos + √(1−amp²)·sin
    # (param.cpp:1546-1574). The upper clamp is 0.9999 ONLY when the amp
    # axis is freed (static["amp_hi"], set by refine_results) — at amp→1
    # the √ branch's gradient diverges and a Newton step would overshoot
    # into NaN territory. With the axis gated off the bound is 1.0 so the
    # objective (and reported amp) pass every legal grid amplitude —
    # including exactly 0.0 and 1.0 — through untouched (review r5: a
    # [1e-4, 0.9999] clamp on the default path shifted the seed logpro
    # and the Output_Refined Amp column for boundary grids). amp = 0 is
    # smooth (d√(1−a²)/da → 0), so no lower clamp is needed.
    amp = jnp.clip(
        consts["amp0"] + theta["dctf"][2].astype(F32),
        0.0,
        static.get("amp_hi", 1.0),
    )
    ctf = smooth_ctf_spectrum(
        n, static["pixel_size"], static["use_psf"], amp, pha, env,
        static.get("cos_n"), static.get("sin_n"),
        static.get("cos_f"), static.get("sin_f"),
    )
    conv_re = proj_re * ctf
    conv_im = proj_im * ctf
    # Five moments in f64 (reference keeps these double: bioem.cpp:1887-1914).
    h = static["h"].astype(F64)
    sum_c = conv_re[0, 0].astype(F64)
    ssq_c = jnp.sum(
        (conv_re.astype(F64) ** 2 + conv_im.astype(F64) ** 2) * h[None, :]
    ) / ntot
    # img bank is prefolded conj(FFT)·h/N² (engine _image_arrays), so the
    # plain product-sum below already includes Hermitian weights and the
    # c2r normalisation of bioem_algorithm.h:163.
    ir = consts["img_re"].astype(F64)
    ii = consts["img_im"].astype(F64)
    cr = conv_re.astype(F64)
    ci = conv_im.astype(F64)
    cc = _cc_at(cr * ir - ci * ii, cr * ii + ci * ir, n, consts["d0"] + theta["d"])
    sr = consts["sum_ref"].astype(F64)
    ssr = consts["ssq_ref"].astype(F64)
    firstele = (
        ntot * (ssr * ssq_c - cc * cc)
        + 2.0 * sr * sum_c * cc
        - ssr * sum_c * sum_c
        - sr * sr * ssq_c
    )
    forlog = ssq_c * ntot - sum_c * sum_c
    # Positivity guard: at a jittered start far from the seed, firstele can
    # round to <= 0, which would NaN this start's whole Newton trajectory.
    # Clamping to tiny keeps the objective finite (and terrible), so the
    # start stays recoverable instead of dead weight.
    tiny = jnp.asarray(1e-300, F64)
    logpro = (3.0 - ntot) * 0.5 * jnp.log(jnp.maximum(firstele, tiny)) + (
        ntot * 0.5 - 2.0
    ) * jnp.log(jnp.maximum((ntot - 2.0) * forlog, tiny))
    from .core.posterior import ctf_prior_term

    logpro = logpro - ctf_prior_term(amp, pha, env, static["p_obj"])
    return logpro


# ---------------------------------------------------------------------------
# Optimizer: damped Newton over the (ω, d, dctf) vector (7 or 8 params)
# ---------------------------------------------------------------------------

def _newton_ascent(objective, vec0, consts, iters):
    """Levenberg-damped Newton ascent of ``objective(vec, consts)``.

    Per iteration: solve (λI − H)s = ∇f (an ascent direction for any λ
    larger than H's top eigenvalue), accept the step only if f improves
    (λ ↓ 0.4×), else reject (λ ↑ 4×) — monotone by construction, and the
    k×k solve (k = len(vec0) ≤ 8) is trivial. Exact H via jax.hessian; on
    an anisotropic surface this is affine-invariant where first-order
    methods need per-axis tuning (module docstring)."""
    dim = vec0.shape[-1]

    def f(v):
        return objective(v, consts)

    g_fn = jax.grad(f)
    h_fn = jax.hessian(f)

    def step(carry, _):
        vec, lam, fv = carry
        g = g_fn(vec)
        h = h_fn(vec)
        s = jnp.linalg.solve(lam * jnp.eye(dim, dtype=F64) - h, g)
        # Singular/overflowed solve → fall back to a small gradient step.
        s = jnp.where(
            jnp.all(jnp.isfinite(s)), s,
            g / (jnp.linalg.norm(g) + 1e-12) * 1e-3,
        )
        nf = f(vec + s)
        ok = nf > fv
        vec = jnp.where(ok, vec + s, vec)
        fv = jnp.where(ok, nf, fv)
        lam = jnp.where(
            ok, jnp.maximum(lam * 0.4, 1e-6), jnp.minimum(lam * 4.0, 1e8)
        )
        return (vec, lam, fv), fv

    state0 = (vec0, jnp.asarray(1.0, F64), f(vec0))
    (vec, _, fv), trace = jax.lax.scan(step, state0, None, length=iters)
    return vec, fv


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

@dataclass
class RefineResult:
    """Per-image refined maximizing parameters (all numpy, f64)."""

    rotmat: np.ndarray  # (I, 3, 3) refined rotations
    quaternion: np.ndarray  # (I, 4) same rotations as (q1,q2,q3,q4)
    cent_x: np.ndarray  # (I,) refined displacement, reference sign (−dx)
    cent_y: np.ndarray
    pha: np.ndarray  # (I,) refined CTF phase (= seed unless refine_ctf)
    env: np.ndarray
    amp: np.ndarray  # (I,) refined amplitude (= seed unless refine_ctf_amp)
    logpro_seed: np.ndarray  # (I,) smooth-model logpro at the grid argmax
    logpro_refined: np.ndarray  # (I,) best over starts (≥ logpro_seed)
    grad_norm: np.ndarray  # (I,) gradient norm at winner (stationarity)


def _rotmat_to_quaternion(r: np.ndarray) -> np.ndarray:
    """Rotation matrices (…,3,3) → quaternions matching the convention of
    ``rotmat_from_quaternion`` (core/orientations.py; reference
    bioem.cpp:1638-1646). Robust Shepperd branch selection."""
    r = np.asarray(r, np.float64)
    out = np.empty(r.shape[:-2] + (4,), np.float64)
    for idx in np.ndindex(r.shape[:-2]):
        m = r[idx]
        # rotmat_from_quaternion builds with q4 = scalar part and rows:
        # m[0,0] = q1²−q2²−q3²+q4², m[0,1] = 2(q1q2+q3q4), …
        t = np.trace(m)
        cand = np.array([m[0, 0], m[1, 1], m[2, 2], t])
        k = int(np.argmax(cand))
        if k == 3:
            q4 = 0.5 * math.sqrt(max(1.0 + t, 0.0))
            q1 = (m[1, 2] - m[2, 1]) / (4.0 * q4)
            q2 = (m[2, 0] - m[0, 2]) / (4.0 * q4)
            q3 = (m[0, 1] - m[1, 0]) / (4.0 * q4)
        elif k == 0:
            q1 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[0, 0] - t, 0.0))
            q2 = (m[0, 1] + m[1, 0]) / (4.0 * q1)
            q3 = (m[2, 0] + m[0, 2]) / (4.0 * q1)
            q4 = (m[1, 2] - m[2, 1]) / (4.0 * q1)
        elif k == 1:
            q2 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[1, 1] - t, 0.0))
            q1 = (m[0, 1] + m[1, 0]) / (4.0 * q2)
            q3 = (m[1, 2] + m[2, 1]) / (4.0 * q2)
            q4 = (m[2, 0] - m[0, 2]) / (4.0 * q2)
        else:
            q3 = 0.5 * math.sqrt(max(1.0 + 2.0 * m[2, 2] - t, 0.0))
            q1 = (m[2, 0] + m[0, 2]) / (4.0 * q3)
            q2 = (m[1, 2] + m[2, 1]) / (4.0 * q3)
            q4 = (m[0, 1] - m[1, 0]) / (4.0 * q3)
        out[idx] = (q1, q2, q3, q4)
    return out


def refine_results(
    engine,
    results,
    iters: int = 60,
    n_starts: int = 16,
    jitter_rot: float = 0.12,
    jitter_disp: Optional[float] = None,
    refine_ctf: bool = False,
    refine_ctf_amp: bool = False,
    image_indices: Optional[np.ndarray] = None,
    seed: int = 0,
) -> RefineResult:
    """Polish each image's grid-argmax parameters by multi-start damped
    Newton on the smooth log posterior. ``engine`` is a run
    :class:`BioEMEngine` (its device banks are reused); ``results`` its
    :class:`Results`.

    Start 0 is the grid seed; the other ``n_starts−1`` jitter ω by
    N(0, jitter_rot) per axis and d uniformly within ±jitter_disp
    (default: 0.6 × the displacement lattice step) — grid-cell-scale
    exploration that rescues seeds whose gradient flow would drain into a
    pixel-scale sidelobe (module docstring). All images × starts run as
    one jitted vmap; the best final log posterior per image wins (always
    ≥ the seed's by monotone accept/reject). ``refine_ctf`` additionally
    optimises the CTF (phase, envelope) pair; ``refine_ctf_amp`` frees the
    amplitude as well, clamped to (0, 1) against the Gaussian amp prior
    (bioem_algorithm.h:49-67). Amp stays pinned by default because
    production grids fix it (reference doc/index.rst:2097-2132) — the
    argmax tuple being polished is bioem.cpp:1141-1222's.
    """
    defs.enable_x64()
    if engine.fspec is None:
        raise ValueError(
            "refine_results requires the Fourier projection layout "
            "(engine.fspec); the raster path has no smooth surrogate. "
            "Rebuild the engine without force_raster and with ≤32 radius "
            "groups."
        )
    if jax.process_count() > 1:
        raise NotImplementedError(
            "refine_results runs single-process (sharded banks are gathered "
            "to the host). In a multi-host run, call it on each host with "
            "image_indices = engine.owned_image_rows()."
        )
    p = engine.p
    banks = engine.banks
    if getattr(engine, "mesh", None) is not None:
        # Mesh engines hold sharded banks; the refinement pass is a cheap
        # per-image post-pass — gather what it reads to the default device.
        banks = banks._replace(
            **{
                f: jnp.asarray(np.asarray(getattr(banks, f)))
                for f in (
                    "img_re", "img_im", "sum_ref", "ssq_ref",
                    "points", "radii", "dens", "norm_den",
                    "st_re", "st_im", "st_sums", "h", "amp", "pha", "env",
                )
            }
        )
    idx = (
        np.arange(engine.n_img)
        if image_indices is None
        else np.asarray(image_indices)
    )
    ang = np.asarray(engine.orients.angles)[np.asarray(results.best_orient)[idx]]
    rot0 = np.asarray(
        rotation_matrices(jnp.asarray(ang), engine.orients.use_quaternions),
        np.float32,
    )
    conv_idx = np.asarray(results.best_conv)[idx]
    amp0 = np.asarray(banks.amp)[conv_idx]
    pha0 = np.asarray(banks.pha)[conv_idx]
    env0 = np.asarray(banks.env)[conv_idx]
    d0 = np.stack(
        [-np.asarray(results.best_cent_x)[idx], -np.asarray(results.best_cent_y)[idx]],
        axis=1,
    ).astype(np.float64)

    n = p.n_pixels
    static = {
        "n": n,
        "ntot": float(p.n_total_pixels),
        "pixel_size": float(p.pixel_size),
        "shift_x": int(p.shift_x),
        "shift_y": int(p.shift_y),
        "use_psf": bool(p.use_psf),
        "fspec": engine.fspec,
        "p_obj": p,
        "points": banks.points,
        "radii": banks.radii,
        "dens": banks.dens,
        "norm_den": banks.norm_den,
        "st_re": banks.st_re,
        "st_im": banks.st_im,
        "st_sums": banks.st_sums,
        "h": banks.h,
        # 0.9999 only when the amp axis is actually freed — see
        # _logpro_smooth's clamp comment.
        "amp_hi": 0.9999 if refine_ctf_amp else 1.0,
    }
    if p.use_psf:
        k1 = np.arange(n)
        ph_n = 2.0 * np.pi * np.outer(k1, k1) / n
        ph_f = 2.0 * np.pi * np.outer(np.arange(n // 2 + 1), k1) / n
        static["cos_n"] = jnp.asarray(np.cos(ph_n), jnp.float32)
        static["sin_n"] = jnp.asarray(np.sin(ph_n), jnp.float32)
        static["cos_f"] = jnp.asarray(np.cos(ph_f), jnp.float32)
        static["sin_f"] = jnp.asarray(np.sin(ph_f), jnp.float32)

    consts = {
        "rot0": jnp.asarray(rot0),
        "amp0": jnp.asarray(amp0, F32),
        "pha0": jnp.asarray(pha0, F32),
        "env0": jnp.asarray(env0, F32),
        "d0": jnp.asarray(d0, F64),
        "img_re": banks.img_re[idx],
        "img_im": banks.img_im[idx],
        "sum_ref": banks.sum_ref[idx],
        "ssq_ref": banks.ssq_ref[idx],
    }
    # Per-component gates: (dpha, denv, damp). The vector is always 8-wide;
    # a zero gate freezes the component exactly (its gradient is zero, so
    # Newton never moves it and the λI damping keeps the solve regular).
    ctf_gate = jnp.asarray(
        [
            1.0 if refine_ctf else 0.0,
            1.0 if refine_ctf else 0.0,
            1.0 if refine_ctf_amp else 0.0,
        ],
        F64,
    )

    def objective(vec, c):
        theta = {
            "omega": vec[:3],
            "d": vec[3:5],
            "dctf": vec[5:8] * ctf_gate,
        }
        return _logpro_smooth(theta, c, static)

    if jitter_disp is None:
        jitter_disp = 0.6 * float(p.grid_space_center)
    rng = np.random.default_rng(seed)
    starts = np.zeros((n_starts, 8))
    if n_starts > 1:
        starts[1:, :3] = rng.normal(0.0, jitter_rot, (n_starts - 1, 3))
        starts[1:, 3:5] = rng.uniform(-jitter_disp, jitter_disp, (n_starts - 1, 2))
        if refine_ctf_amp:
            # Grid-cell-scale amp exploration (grids step amp by ~0.05-0.1).
            starts[1:, 7] = rng.uniform(-0.05, 0.05, n_starts - 1)
    starts_j = jnp.asarray(starts, F64)

    def per_image(c):
        seed_logpro = objective(jnp.zeros(8, F64), c)
        vecs, finals = jax.vmap(
            lambda v0: _newton_ascent(objective, v0, c, iters)
        )(starts_j)
        best = jnp.argmax(finals)
        vec = vecs[best]
        g = jax.grad(lambda v: objective(v, c))(vec)
        return vec, seed_logpro, finals[best], jnp.linalg.norm(g)

    vec, lp0, lp1, gnorm = jax.jit(jax.vmap(per_image))(consts)

    vec = np.asarray(vec, np.float64)
    rot = np.asarray(
        jax.vmap(
            lambda w, r: jnp.matmul(
                exp_so3(w.astype(F32)), r,
                precision=jax.lax.Precision.HIGHEST,
            )
        )(jnp.asarray(vec[:, :3]), jnp.asarray(rot0)),
        np.float64,
    )
    d = d0 + vec[:, 3:5]
    dctf = vec[:, 5:8] * np.asarray(ctf_gate, np.float64)
    return RefineResult(
        rotmat=rot,
        quaternion=_rotmat_to_quaternion(rot),
        cent_x=-d[:, 0],
        cent_y=-d[:, 1],
        pha=pha0 + dctf[:, 0],
        env=np.maximum(env0 + dctf[:, 1], ENV_FLOOR),
        amp=(
            np.clip(amp0 + dctf[:, 2], 0.0, 0.9999).astype(np.float64)
            if refine_ctf_amp
            else amp0.astype(np.float64)  # grid value passes through exactly
        ),
        logpro_seed=np.asarray(lp0, np.float64),
        logpro_refined=np.asarray(lp1, np.float64),
        grad_norm=np.asarray(gnorm, np.float64),
    )
