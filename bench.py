"""Benchmark: image×orientation comparisons/s/card vs a CPU reference proxy.

One "comparison" = one (image, orientation, ctf) posterior contribution
integrated over the full displacement grid (BASELINE.md). The baseline is a
vectorised NumPy implementation of the reference algorithm (full-map c2r FFT
cross-correlation + per-lattice-point double-precision log-posterior, the
same algorithm as /root/reference/bioem.cpp:1435-1459 + bioem_algorithm.h),
measured live on this host and scaled by core count (the reference
parallelises over images with OpenMP, map.cpp/bioem.cpp:1392).

Needs a GPU: without one it exits non-zero and prints no number. Prints the
card's identity, then one JSON line: {"metric", "value", "unit",
"vs_baseline", "device", ...}.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

# Benchmark configuration (BASELINE config 2 scale: ~4.4k-orientation
# quaternion grid × defocus/env CTF bank × 21×21 displacement lattice at
# production N=224; reference doc/index.rst:2097-2132 uses ≥4608
# orientations).
N_PIXELS = int(os.environ.get("BENCH_NPIX", 224))
N_IMG = int(os.environ.get("BENCH_NIMG", 64))
QUAT_GRID = int(os.environ.get("BENCH_QUATGRID", 15))  # → 4352 orientations
MAX_DISP, DISP_STEP = 20, 2
REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
BASELINE_SAMPLE_OC = int(os.environ.get("BENCH_BASELINE_SAMPLE", 4))
PIXEL_SIZE = 1.06
N_POINTS = 500  # ~protein-complex Cα count


def bench_params(n_pixels=N_PIXELS, quat_grid=QUAT_GRID):
    from bioem_tpu.params import BioEMParams

    return BioEMParams(
        pixel_size=PIXEL_SIZE,
        n_pixels=n_pixels,
        use_quaternions=True,
        grid_points_quaternion=quat_grid,
        n_amp=1,
        start_amp=0.1,
        end_amp=0.1,
        n_phase=4,
        start_defocus=0.5,
        end_defocus=2.5,
        n_env=2,
        start_bfactor=2.0,
        end_bfactor=100.0,
        max_displace_center=MAX_DISP,
        grid_space_center=DISP_STEP,
    ).finalize_ctf_mode()


def residue_ball_model(rng, n_points=N_POINTS, radius=100.0):
    """Points uniform in a ball of ``radius`` Å, with radii and densities
    drawn from the PDB residue tables (the production model shape: ≤20
    distinct radii, reference model.cpp:738-844). Not yet centred."""
    from bioem_tpu.io.model_io import AA_DENSITY, AA_RADIUS, Model

    u = rng.normal(size=(n_points, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (u * radius * rng.uniform(size=(n_points, 1)) ** (1 / 3)).astype(np.float32)
    residues = rng.choice(list(AA_RADIUS), n_points)
    radii = np.array([AA_RADIUS[r] for r in residues], np.float32)
    dens = np.array([AA_DENSITY[r] for r in residues], np.float32)
    return Model(pts, radii, dens, float(dens.sum()))


def build_problem(n_pixels=N_PIXELS, n_img=N_IMG, quat_grid=QUAT_GRID, seed=0):
    """(params, orientations, model, images) of the bench problem, from
    ``seed``. The images are unit Gaussian noise."""
    from bioem_tpu.io.map_io import ImageStack
    from bioem_tpu.core.orientations import build_orientations

    p = bench_params(n_pixels, quat_grid)
    orients = build_orientations(p)
    rng = np.random.default_rng(seed)
    # Radius 100 Å at N=224: with the 224 px × 1.06 Å frame (±118.7 Å)
    # every rotation projects fully in-bounds; scaled with N below that.
    model = residue_ball_model(
        rng, radius=100.0 * min(n_pixels, 224) / 224
    ).center_density_mass()
    maps = rng.normal(0, 1, (n_img, n_pixels, n_pixels)).astype(np.float32)
    return p, orients, model, ImageStack(maps)


def bench_engine(p, orients, model, images):
    import jax
    from bioem_tpu.config import RunConfig
    from bioem_tpu.run import make_engine, maybe_autotune

    cfg = RunConfig.from_env()
    # Autotune (reference analogue: autotuner.cpp runs by default on GPU
    # builds). The bench problem is above AUTOTUNE_MIN_COMPARISONS, so this
    # times the shape-derived candidates and picks the fastest.
    cfg = maybe_autotune(p, orients, model, images, cfg)
    eng = make_engine(p, orients, model, images, cfg)
    state = eng.run()  # warmup/compile
    jax.block_until_ready(state.total)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state = eng.run()
        jax.block_until_ready(state.total)
        best = min(best, time.perf_counter() - t0)
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    n_chips = cfg.mesh_images * cfg.mesh_orient
    return comparisons / best / n_chips, comparisons


def bench_numpy_baseline(p, orients, model, images):
    """Reference-algorithm proxy: full irfft2 CC + f64 logpro at the lattice."""
    from bioem_tpu.core.ctf import build_ctf_bank
    from bioem_tpu.params import displacement_lists, make_ctf_grid
    from tests.oracle.oracle import project, rotmat_quat

    n = p.n_pixels
    grid = make_ctf_grid(p)
    bank = build_ctf_bank(p, grid)
    disp, cent = displacement_lists(p)
    maps = images.maps
    img_fft = np.fft.rfft2(maps)
    img_fft_c = np.conj(img_fft)
    sref = maps.reshape(len(maps), -1).sum(1)
    ssref = (maps.reshape(len(maps), -1) ** 2).sum(1)
    ntot = p.n_total_pixels

    proj = project(
        p,
        model.points.astype(np.float64),
        model.radii,
        model.densities,
        model.norm_den,
        rotmat_quat(orients.angles[0]),
    )
    proj_fft = np.fft.rfft2(proj)

    n_sample = min(BASELINE_SAMPLE_OC, grid.n)
    # Best-of-2 passes: the baseline is timed on a (possibly contended)
    # host CPU — a single pass can be several× slow and would inflate
    # vs_baseline arbitrarily between otherwise-identical runs.
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for c in range(n_sample):
            conv = proj_fft * np.conj(bank[c])
            s_c = conv[0, 0].real
            ss_c = np.sum(np.abs(conv[:, 1:-1]) ** 2) * 2 + np.sum(
                np.abs(conv[:, [0, -1]]) ** 2
            )
            ss_c /= ntot
            cc_full = np.fft.irfft2(conv[None] * img_fft_c, s=(n, n))  # (I, N, N)
            cc = cc_full[:, cent][:, :, cent]  # (I, D, D)
            forlog = ss_c * ntot - s_c * s_c
            firstele = (
                ntot * (ssref[:, None, None] * ss_c - cc * cc)
                + 2 * sref[:, None, None] * s_c * cc
                - ssref[:, None, None] * s_c * s_c
                - sref[:, None, None] ** 2 * ss_c
            )
            logpro = (3 - ntot) * 0.5 * np.log(firstele) + (
                ntot * 0.5 - 2
            ) * np.log((ntot - 2) * forlog)
            mx = logpro.max(axis=(1, 2))
            np.exp(logpro - mx[:, None, None]).sum(axis=(1, 2))
        best = min(best, time.perf_counter() - t0)
    comparisons_sampled = n_sample * len(maps)
    ncores = os.cpu_count() or 1
    return comparisons_sampled / best * ncores


# Golden cases exercised on the LIVE backend (the 70+-test suite pins CPU
# only): CTF mode + Euler grid (a), PSF mode + quaternion list (b), and the
# MRC particle-stack ingest path (c). Reference analogue: the doc's
# cross-implementation consistency contract (doc/index.rst:1519-1533).
ACCURACY_CASES = {
    "case_a_euler_ctf": ("maps.txt", ()),
    "case_b_quat_psf": ("maps.txt", ("--ReadOrientation", "quat.txt")),
    "case_c_mrc_stack": ("maps.mrc", ("--ReadMRC",)),
}

# Production-N (224) golden, run on the live backend separately: its
# |Δlog P| is LIMITED BY THE REFERENCE's own float32 pixel path — the f64
# oracle sits 7.7e-2 from this golden while the engine tracks the oracle to
# ~5e-7 (tools/golden_error_budget.py; tests/test_golden.py
# test_engine_beats_reference_precision). Reported as its own field so the
# N=16 metric stays comparable across rounds.
ACCURACY_CASES_N224 = {
    "case_n_n224": ("maps.txt", ("--ReadOrientation", "euler.txt")),
}


def bench_accuracy(cases=None):
    """BASELINE.md accuracy metric: worst max |Δlog P| vs the reference
    binary's golden outputs over ``cases`` (default ACCURACY_CASES),
    measured on the current backend. None if goldens are absent."""
    import shutil
    import tempfile

    data = os.path.join(os.path.dirname(__file__), "tests", "golden", "data")
    import re

    import numpy as np

    from bioem_tpu.cli import main as cli_main

    def parse(text):
        vals = {}
        for line in text.splitlines():
            m = re.match(r"RefMap: (\d+) LogProb:\s+(\S+)", line)
            if m:
                vals[int(m.group(1))] = float(m.group(2))
        return np.array([vals[i] for i in range(len(vals))])

    worst = None
    for case, (maps_file, extra) in (cases or ACCURACY_CASES).items():
        src = os.path.join(data, case)
        if not os.path.isdir(src):
            continue
        with tempfile.TemporaryDirectory() as td:
            work = os.path.join(td, "case")
            shutil.copytree(src, work)
            old = os.getcwd()
            os.chdir(work)
            try:
                cli_main([
                    "--Modelfile", "model.txt", "--Particlesfile", maps_file,
                    "--Inputfile", "param.txt",
                    "--OutputFile", "Output_Probabilities.ours",
                    *extra,
                ])
                with open("Output_Probabilities.ours") as f:
                    ours = parse(f.read())
                with open("Output_Probabilities.golden") as f:
                    golden = parse(f.read())
            finally:
                os.chdir(old)
        delta = float(np.max(np.abs(ours - golden)))
        worst = delta if worst is None else max(worst, delta)
    return worst


def device_identity():
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit from nvidia-smi. Raises unless JAX runs on a GPU:
    this benchmark's numbers are device metrics and have no CPU fallback."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        card = f"nvidia-smi unavailable ({e})"
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card,
    }


def main():
    from bioem_tpu.config import use_compile_cache

    use_compile_cache()
    device = device_identity()
    print(f"device: {device}", flush=True)
    p, orients, model, images = build_problem()
    rate, comparisons = bench_engine(p, orients, model, images)
    base_rate = bench_numpy_baseline(p, orients, model, images)
    max_dlogp = bench_accuracy()
    max_dlogp_n224 = bench_accuracy(ACCURACY_CASES_N224)
    rec = {
        "metric": "image×orientation×ctf comparisons/s/card",
        "value": rate,
        "unit": "comparisons/s",
        "vs_baseline": rate / base_rate,
        # vs_baseline is a PROXY — a live NumPy reimplementation of the
        # reference algorithm scaled by host core count, NOT the
        # reference's own published cluster scaling.
        "baseline_kind": "numpy-proxy×cores",
        # worst max |Δlog P| vs the compiled reference binary's golden
        # outputs (CTF+Euler, PSF+quaternions, MRC stack — ACCURACY_CASES)
        # on this device.
        "max_abs_dlogp_vs_reference": max_dlogp,
        "accuracy_cases": len(ACCURACY_CASES),
        # Production-N=224 golden on this device. This delta is the
        # REFERENCE's own f32 quadrature error (~1.5e-6·N²): the engine
        # tracks the f64 oracle to ~5e-7 at this N (golden_error_budget.py).
        "max_abs_dlogp_vs_reference_n224": max_dlogp_n224,
        "device": device,
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
