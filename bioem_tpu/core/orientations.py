"""Orientation grids, lists, and rotation matrices.

JAX equivalent of the reference orientation-grid generator
(/root/reference/param.cpp:988-1334) and the rotation-matrix construction in
``createProjection`` (/root/reference/bioem.cpp:1627-1673).

Orientations are represented uniformly as an (n, 4) float32 array: Euler
modes store (alpha, beta, gamma, 0); quaternion modes store (q1, q2, q3, q4).
A separate ``use_quaternions`` flag selects the rotation formula, matching
the reference's ``myfloat3_t{pos[3], quat4}`` layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..params import BioEMParams, ParamError


@dataclass
class OrientationSet:
    angles: np.ndarray  # (n, 4) float32
    use_quaternions: bool
    voluang: float  # orientation-integration volume element (incl. priorMod)
    priors: Optional[np.ndarray] = None  # (n,) optional per-orientation log-prior

    @property
    def n(self) -> int:
        return self.angles.shape[0]


def euler_grid(p: BioEMParams) -> OrientationSet:
    """Uniform Euler grid: α,γ ∈ [−π,π), cos β ∈ [−1,1), cell-centred.

    Reference param.cpp:1009-1048. Loop order (α outer, β, γ inner) fixes
    the orientation index used in output files.
    """
    na, nb = p.grid_points_alpha, p.grid_points_beta
    ga = 2.0 * math.pi / na
    gb = 2.0 / nb
    ia = np.arange(na, dtype=np.float32)
    ib = np.arange(nb, dtype=np.float32)
    alphas = ia * np.float32(ga) - np.float32(math.pi) + np.float32(ga * 0.5)
    betas = np.arccos(ib * np.float32(gb) - 1 + np.float32(gb * 0.5))
    gammas = alphas
    A, B, G = np.meshgrid(alphas, betas, gammas, indexing="ij")
    ang = np.stack([A.ravel(), B.ravel(), G.ravel(), np.zeros(na * nb * na, np.float32)], axis=1)
    voluang = ga * ga * gb / (2.0 * math.pi) / (2.0 * math.pi) / 2.0 * p.prior_model
    return OrientationSet(ang.astype(np.float32), False, voluang)


def quaternion_grid(p: BioEMParams) -> OrientationSet:
    """Uniform quaternion-ball grid with ±q4 halves (param.cpp:1138-1210)."""
    gq = p.grid_points_quaternion
    if gq < 0:
        raise ParamError("Missing gridpoints quaternions")
    d = 2.0 / (gq + 1)
    vals = np.arange(gq + 1, dtype=np.float64) * d - 1.0 + 0.5 * d
    q1, q2, q3 = np.meshgrid(vals, vals, vals, indexing="ij")
    inside = (q1 * q1 + q2 * q2 + q3 * q3) <= 1.0
    q1, q2, q3 = q1[inside], q2[inside], q3[inside]
    q4 = np.sqrt(1.0 - q1 * q1 - q2 * q2 - q3 * q3)
    # Interleave (+q4, −q4) pairs in the reference's enumeration order.
    n = q1.shape[0]
    ang = np.empty((2 * n, 4), np.float32)
    ang[0::2] = np.stack([q1, q2, q3, q4], axis=1)
    ang[1::2] = np.stack([q1, q2, q3, -q4], axis=1)
    voluang = d * d * d * p.prior_model
    return OrientationSet(ang, True, voluang)


def read_orientation_file(p: BioEMParams, path: str) -> OrientationSet:
    """Read a fixed-width orientation list (param.cpp:1050-1133, 1213-1327).

    Format: first line = count (in columns 0-11); then 12-char fixed-width
    fields: Euler (α β γ [prior]) or quaternion (q1 q2 q3 q4 [prior]).
    """
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise ParamError(f"Empty orientation file {path}")
    ntot = int(lines[0][:12].split()[0])
    if ntot < 1:
        raise ParamError(f"Invalid number of orientations {ntot}")
    rows = []
    priors = [] if p.prior_angles else None
    nfields = 4 if p.use_quaternions else 3
    for line in lines[1:]:
        if not line.strip():
            continue
        vals = [float(line[12 * k : 12 * (k + 1)]) for k in range(nfields)]
        if p.use_quaternions:
            for v in vals:
                if v < -1 or v > 1:
                    raise ParamError(f"Quaternion value out of range {v}")
            rows.append(vals)
        else:
            rows.append(vals + [0.0])
        if p.prior_angles:
            pp = float(line[12 * nfields : 12 * (nfields + 1)])
            priors.append(pp)
        if len(rows) > ntot:
            raise ParamError(f"More orientations than expected in header: {len(rows)} > {ntot}")
    if len(rows) < ntot:
        raise ParamError(f"Less orientations than expected in header: {len(rows)} < {ntot}")
    ang = np.asarray(rows, dtype=np.float32)
    voluang = 1.0 / ntot * p.prior_model
    return OrientationSet(
        ang, p.use_quaternions, voluang,
        priors=np.asarray(priors, np.float32) if priors is not None else None,
    )


def build_orientations(p: BioEMParams, orientation_file: Optional[str] = None) -> OrientationSet:
    """Dispatch matching reference CalculateGridsParam (param.cpp:988-1334)."""
    if p.not_uniform_angles:
        if orientation_file is None:
            raise ParamError("Orientation file required with --ReadOrientation")
        return read_orientation_file(p, orientation_file)
    if p.prior_angles:
        raise ParamError(
            "PRIOR_ANGLES requires a separate orientation file (--ReadOrientation)"
        )
    if p.use_quaternions:
        return quaternion_grid(p)
    return euler_grid(p)


# ---------------------------------------------------------------------------
# Rotation matrices (jit-safe; operate on (n, 4) angle arrays)
# ---------------------------------------------------------------------------

def rotmat_from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrices from quaternion rows (x, y, z, w).

    Matches reference bioem.cpp:1638-1646 element-for-element (note the
    reference matrix is the transpose of the usual wikipedia convention;
    points are rotated as r' = R @ r with this R).
    Input (..., 4) → output (..., 3, 3).
    """
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * q1 * q1 - 2 * q2 * q2
    r10 = 2 * (q0 * q1 - q2 * q3)
    r20 = 2 * (q0 * q2 + q1 * q3)
    r01 = 2 * (q0 * q1 + q2 * q3)
    r11 = 1 - 2 * q0 * q0 - 2 * q2 * q2
    r21 = 2 * (q1 * q2 - q0 * q3)
    r02 = 2 * (q0 * q2 - q1 * q3)
    r12 = 2 * (q1 * q2 + q0 * q3)
    r22 = 1 - 2 * q0 * q0 - 2 * q1 * q1
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotmat_from_euler(ang: jnp.ndarray) -> jnp.ndarray:
    """ZXZ Euler rotation matrices (Goldstein convention).

    Matches reference bioem.cpp:1664-1672. Input (..., ≥3) rows of
    (alpha, beta, gamma); output (..., 3, 3).
    """
    a, b, g = ang[..., 0], ang[..., 1], ang[..., 2]
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cg, sg = jnp.cos(g), jnp.sin(g)
    r00 = cg * ca - cb * sa * sg
    r01 = cg * sa + cb * ca * sg
    r02 = sg * sb
    r10 = -sg * ca - cb * sa * cg
    r11 = -sg * sa + cb * ca * cg
    r12 = cg * sb
    r20 = sb * sa
    r21 = -sb * ca
    r22 = cb
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotation_matrices(ang: jnp.ndarray, use_quaternions: bool) -> jnp.ndarray:
    """(n, 4) orientation rows → (n, 3, 3) rotation matrices."""
    if use_quaternions:
        return rotmat_from_quaternion(ang)
    return rotmat_from_euler(ang)
