"""Smoke test of the posterior engine on one NVIDIA GPU.

    python chip_smoke.py           # phases device, golden, planted, e2e (1 card)
    python chip_smoke.py --four    # the image × orientation mesh on 4 cards

Phases, in order; the first that fails ends the run with a non-zero exit:

* ``device``  — JAX's platform, device kind and count, and the card's name
  and power limit from nvidia-smi. Fails unless JAX runs on a GPU.
* ``golden``  — golden cases through ``cli.main`` against the reference
  binary's outputs: the full-double goldens and three float32 ones.
* ``planted`` — an N=224 particle planted at a known orientation, CTF and
  displacement: the argmax must recover it, log P(planted) must sit far
  above log P(noise); then one ``refine_results`` pass.
* ``e2e``     — the bench problem (N=224, 4,352 orientations, 8 CTFs,
  21×21 lattice, 64 particles, 500-point model) written as reference-format
  files and run through ``cli.main`` with the autotuner.

``--four`` runs only the sharded bench problem on 2×2 and 1×4 meshes
against the single-card run of the same problem.

Every contraction runs at ``precision=HIGHEST``, i.e. full float32 and not
TF32 (tests/test_precision_lint.py); the tolerances below assume that.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DATA = os.path.join(ROOT, "tests", "golden", "data")

# Full-double reference goldens. 2e-3 log-units as in
# tests/test_golden.py::test_golden_f64_external_truth (f32 engine with f64
# constants, HIGHEST-precision matmuls; the file format prints 4 decimals).
F64_GOLDEN_ATOL = 2e-3
F64_CASES = ("case_n_n224", "case_l_n64", "case_a_euler_ctf")
# Float32 reference goldens, at tests/test_golden.py's per-case tolerances
# (LOGP_ATOL = 1e-3 for these three; HIGHEST-precision matmuls, as on the
# CPU the tolerances were set on).
F32_CASES = ("case_b_quat_psf", "case_c_mrc_stack", "case_k_quat_grid")

# Sharded vs single-card log P: relative to the largest |log P|, as
# __graft_entry__.dryrun_multichip asserts. Both run HIGHEST-precision f32
# matmuls; shards see other array shapes, so XLA may pick other matmul
# algorithms: last-bit f32 differences only.
SHARDED_RTOL = 1e-6

# Planted recovery: log P(planted) − log P(noise) must exceed this.
PLANTED_MARGIN = 100.0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(msg)


@contextlib.contextmanager
def workdir(src: str = ""):
    """Temporary working directory (optionally a copy of ``src``)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        work = os.path.join(td, "work")
        if src:
            shutil.copytree(src, work)
        else:
            os.makedirs(work)
        old = os.getcwd()
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(old)


# ---------------------------------------------------------------------------
# Comparators (pure; raise AssertionError on a wrong result)
# ---------------------------------------------------------------------------


def check_golden(case: str, ours: str, golden: str, atol: float,
                 n_ang: int, params_exact: bool) -> float:
    """max |Δlog P| of two Output_Probabilities texts, asserted ≤ ``atol``.

    With ``params_exact`` the maximizing angles and CTF parameters must
    also agree to print precision and the centers exactly, as the f64
    golden test requires."""
    from tests.test_golden import parse_output

    lp_o, _, par_o = parse_output(ours)
    lp_g, _, par_g = parse_output(golden)
    require(len(lp_o) == len(lp_g) > 0, (case, len(lp_o), len(lp_g)))
    require(np.isfinite(lp_o).all(), f"{case}: non-finite log P")
    delta = float(np.max(np.abs(lp_o - lp_g)))
    require(delta <= atol, f"{case}: max |Δlog P| = {delta:.3e} > {atol:g}")
    if params_exact:
        for i, (po, pg) in enumerate(zip(par_o, par_g)):
            np.testing.assert_allclose(
                po[1:n_ang + 4], pg[1:n_ang + 4], atol=1e-4,
                err_msg=f"{case} image {i}: maximizing angles/CTF",
            )
            np.testing.assert_array_equal(
                po[n_ang + 4:n_ang + 6], pg[n_ang + 4:n_ang + 6],
                err_msg=f"{case} image {i}: maximizing center",
            )
    return delta


def check_sharded(res, ref, label: str) -> float:
    """Sharded vs single-device Results: log P within SHARDED_RTOL × scale,
    equal argmax orientation and displacement. Returns max |Δlog P|."""
    lp, lp_ref = np.asarray(res.log_prob), np.asarray(ref.log_prob)
    require(lp.shape == lp_ref.shape, (label, lp.shape, lp_ref.shape))
    require(np.isfinite(lp).all(), f"{label}: non-finite log P")
    diff = float(np.max(np.abs(lp - lp_ref)))
    scale = max(1.0, float(np.max(np.abs(lp_ref))))
    require(diff <= SHARDED_RTOL * scale, (
        f"{label}: max |Δlog P| = {diff:.3e} > {SHARDED_RTOL:g} × {scale:.4g}"
    ))
    for field in ("best_orient", "best_cent_x", "best_cent_y"):
        a, b = np.asarray(getattr(res, field)), np.asarray(getattr(ref, field))
        bad = np.flatnonzero(a != b)
        require(bad.size == 0, (
            f"{label}: {field} differs for images {bad.tolist()}: "
            f"{a[bad].tolist()} vs {b[bad].tolist()}"
        ))
    return diff


def check_planted(res, truth: dict, margin: float = PLANTED_MARGIN) -> float:
    """Image 0 is planted at ``truth``; image 1 is noise. Returns the log P
    gap between them."""
    got = {
        "orient": int(res.best_orient[0]), "conv": int(res.best_conv[0]),
        "dx": int(res.best_cent_x[0]), "dy": int(res.best_cent_y[0]),
    }
    require(got == truth, f"planted argmax {got} != truth {truth}")
    gap = float(res.log_prob[0] - res.log_prob[1])
    require(gap > margin,
            f"log P(planted) − log P(noise) = {gap:.4g} ≤ {margin}")
    return gap


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def card_name_and_power() -> str:
    """``name, power.limit`` of each card, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


def phase_device(n_devices: int) -> dict:
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    log(f"jax {jax.__version__}: platform={info['platform']} "
        f"kind={info['kind']} count={info['count']}")
    if info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {info['platform']!r}")
    if info["count"] < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, JAX sees {info['count']}")
    return info


def run_golden_case(case: str, golden_name: str) -> tuple[str, str]:
    """Run one golden case through cli.main; returns (ours, golden)."""
    from bioem_tpu.cli import main as cli_main
    from tests.test_golden import CASES

    model_file, maps_file, extra, _, _, _ = CASES[case]
    with workdir(os.path.join(GOLDEN_DATA, case)):
        rc = cli_main([
            "--Modelfile", model_file, "--Particlesfile", maps_file,
            "--Inputfile", "param.txt", "--OutputFile", "Output_Probabilities.ours",
            *extra,
        ])
        require(rc == 0, f"{case}: cli.main returned {rc}")
        with open("Output_Probabilities.ours") as f:
            ours = f.read()
        with open(golden_name) as f:
            golden = f.read()
    return ours, golden


def phase_golden() -> None:
    from tests.test_golden import CASE_ATOL, CASES, LOGP_ATOL

    for case in F64_CASES:
        t0 = time.perf_counter()
        ours, golden = run_golden_case(case, "Output_Probabilities.f64.golden")
        n_ang = CASES[case][4]
        d = check_golden(case, ours, golden, F64_GOLDEN_ATOL, n_ang, True)
        log(f"golden {case} vs f64 reference: max |dlogP| = {d:.3e} "
            f"(atol {F64_GOLDEN_ATOL:g}) [{time.perf_counter() - t0:.1f} s]")
    for case in F32_CASES:
        t0 = time.perf_counter()
        ours, golden = run_golden_case(case, "Output_Probabilities.golden")
        atol = CASE_ATOL.get(case, LOGP_ATOL)
        d = check_golden(case, ours, golden, atol, CASES[case][4], False)
        log(f"golden {case} vs f32 reference: max |dlogP| = {d:.3e} "
            f"(atol {atol:g}) [{time.perf_counter() - t0:.1f} s]")


def phase_planted(n_pixels=224, quat_grid=4, seed=7) -> None:
    """examples/planted_recovery.py at N=224 on the bench CTF/lattice."""
    import bioem_tpu
    from bench import bench_params, residue_ball_model
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.ctf import build_ctf_bank
    from bioem_tpu.core.engine import BioEMEngine
    from bioem_tpu.core.orientations import build_orientations
    from bioem_tpu.io.map_io import ImageStack
    from bioem_tpu.params import make_ctf_grid
    from tests.oracle.oracle import project, rotmat_quat

    p = bench_params(n_pixels, quat_grid)
    orients = build_orientations(p)
    rng = np.random.default_rng(seed)
    model = residue_ball_model(
        rng, radius=0.4 * n_pixels * p.pixel_size
    ).center_density_mass()
    truth = {"orient": orients.n // 3, "conv": 5, "dx": 4, "dy": -6}

    bank = build_ctf_bank(p, make_ctf_grid(p))
    proj = project(
        p, model.points.astype(np.float64), model.radii, model.densities,
        model.norm_den, rotmat_quat(orients.angles[truth["orient"]]),
    )
    n = n_pixels
    conv = np.fft.irfft2(np.fft.rfft2(proj) * np.conj(bank[truth["conv"]]), s=(n, n))
    img = np.roll(conv, (truth["dx"], truth["dy"]), axis=(0, 1))
    img = img + rng.normal(0, 0.1 * img.std(), img.shape)
    img = (img - img.mean()) / img.std()  # normalise like MRC ingest
    noise = rng.normal(0, 1, (n, n))
    images = ImageStack(np.stack([img, noise]).astype(np.float32))

    t0 = time.perf_counter()
    eng = BioEMEngine(p, orients, model, images, RunConfig(orient_block=8))
    res = eng.results(eng.run())
    gap = check_planted(res, truth)
    log(f"planted N={n}: {orients.n} orientations x {eng.n_ctf} CTFs, "
        f"argmax = truth {truth}, logP(planted) - logP(noise) = {gap:.6g} "
        f"[{time.perf_counter() - t0:.1f} s]")
    log("PLANTED-PARAMETER RECOVERY: PASS")

    t0 = time.perf_counter()
    ref = bioem_tpu.refine_results(eng, res, image_indices=[0], n_starts=8, iters=40)
    ok = (
        ref.logpro_refined[0] >= ref.logpro_seed[0]
        and abs(ref.cent_x[0] - truth["dx"]) < 1.0
        and abs(ref.cent_y[0] - truth["dy"]) < 1.0
        and np.isfinite(ref.grad_norm[0])
    )
    log(f"refine: logpro {ref.logpro_seed[0]:.6g} -> {ref.logpro_refined[0]:.6g}, "
        f"cent ({ref.cent_x[0]:+.3f}, {ref.cent_y[0]:+.3f}), "
        f"grad norm {ref.grad_norm[0]:.3e} [{time.perf_counter() - t0:.1f} s]")
    require(ok, "continuous refinement lost log P or left the planted center")
    log("CONTINUOUS REFINEMENT: PASS")


def write_bench_inputs(n_pixels: int, quat_grid: int, n_img: int) -> None:
    """bench.build_problem's model and particles as reference-format files
    in the working directory: model.txt (x y z radius density),
    particles.mrc and param.txt."""
    from bench import MAX_DISP, DISP_STEP, build_problem
    from bioem_tpu.io.mrc import write_mrc

    p, _, model, images = build_problem(n_pixels, n_img, quat_grid)
    with open("model.txt", "w") as f:
        for k in range(model.n_points):
            x, y, z = model.points[k]
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {model.radii[k]:.6f} "
                    f"{model.densities[k]:.6f}\n")
    # MRC stores transposed sections (reference map.cpp:663-853).
    write_mrc("particles.mrc", np.transpose(images.maps, (0, 2, 1)), p.pixel_size)
    with open("param.txt", "w") as f:
        f.write(
            f"PIXEL_SIZE {p.pixel_size}\n"
            f"NUMBER_PIXELS {n_pixels}\n"
            "USE_QUATERNIONS\n"
            f"GRIDPOINTS_QUATERNION {quat_grid}\n"
            "CTF_B_ENV 2.0 100.0 2\n"
            "CTF_DEFOCUS 0.5 2.5 4\n"
            "CTF_AMPLITUDE 0.1 0.1 1\n"
            f"DISPLACE_CENTER {MAX_DISP} {DISP_STEP}\n"
        )


def read_logprobs(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            m = re.match(r"RefMap: (\d+) LogProb:\s+(\S+)", line)
            if m:
                vals.append(float(m.group(2)))
    return np.array(vals)


def phase_e2e(n_pixels=224, quat_grid=15, n_img=64, card="") -> None:
    import jax

    from bioem_tpu.cli import main as cli_main
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.orientations import build_orientations
    from bioem_tpu.io.map_io import read_ref_maps
    from bioem_tpu.io.model_io import read_model
    from bioem_tpu.params import read_parameters
    from bioem_tpu.run import make_engine, maybe_autotune
    from bioem_tpu.runtime import native

    with workdir():
        write_bench_inputs(n_pixels, quat_grid, n_img)
        argv = [
            "--Modelfile", "model.txt", "--Particlesfile", "particles.mrc",
            "--ReadMRC", "--Inputfile", "param.txt",
            "--OutputFile", "Output_Probabilities",
        ]
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        require(rc == 0, f"cli.main returned {rc}")
        reader = "native C++" if native.get_lib() is not None else "NumPy"
        log(f"particle reader: {reader}")
        lp_cli = read_logprobs("Output_Probabilities")
        require(lp_cli.shape == (n_img,),
                f"{lp_cli.shape[0]} LogProb lines, want {n_img}")
        require(np.isfinite(lp_cli).all(),
                "non-finite LogProb in Output_Probabilities")
        log(f"Output_Probabilities: {n_img} finite LogProb lines")

        # Same inputs through the API, for the steady-state rate and the
        # block step's memory: the autotuner hits the cache the CLI wrote.
        p = read_parameters("param.txt")
        images = read_ref_maps("particles.mrc", p.n_pixels, read_mrc=True,
                               normalize=not p.no_map_norm)
        model = read_model("model.txt", pixel_size=p.pixel_size)
        orients = build_orientations(p)
        cfg = maybe_autotune(p, orients, model, images, RunConfig.from_env())
        eng = make_engine(p, orients, model, images, cfg)
        jax.block_until_ready(eng.run().total)  # compile
        t0 = time.perf_counter()
        state = eng.run()
        jax.block_until_ready(state.total)
        run_s = time.perf_counter() - t0
        res = eng.results(state)
        cmp_n = eng.n_orient * eng.n_ctf * eng.n_img
        # The file prints 4 decimals.
        np.testing.assert_allclose(res.log_prob, lp_cli, rtol=0, atol=2e-4)

    log(f"e2e N={n_pixels} {eng.n_orient} orientations x {eng.n_ctf} CTFs x "
        f"{eng.n_img} images, D={len(eng.disp)}: cli wall {wall:.3f} s "
        f"(ingest, autotune, compile, run, output); steady run {run_s:.4f} s "
        f"= {cmp_n / run_s:.6g} comparisons/s; orient_block={eng.o_block} "
        f"image_block={eng.i_block}; card: {card}")
    args = (eng.initial_state(), eng.banks, eng.ang_blocks[0],
            eng.offsets[0], eng.mask_blocks[0])
    mem = eng._step.lower(*args).compile().memory_analysis()
    log(f"block step memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")


def phase_four(n_pixels=224, quat_grid=15, n_img=64) -> None:
    """Bench problem on (2, 2) and (1, 4) meshes vs one card."""
    import jax

    from bench import build_problem
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.engine import BioEMEngine
    from bioem_tpu.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh

    p, orients, model, images = build_problem(n_pixels, n_img, quat_grid)
    t0 = time.perf_counter()
    single = BioEMEngine(p, orients, model, images, RunConfig())
    ref = single.results(single.run())
    log(f"single card: {single.n_orient} orientations x {single.n_ctf} CTFs x "
        f"{single.n_img} images [{time.perf_counter() - t0:.1f} s]")
    for shape in ((2, 2), (1, 4)):
        t0 = time.perf_counter()
        cfg = RunConfig(mesh_images=shape[0], mesh_orient=shape[1])
        eng = ShardedBioEMEngine(p, orients, model, images, cfg,
                                 mesh=make_bioem_mesh(*shape))
        res = eng.results(eng.run())
        jax.block_until_ready(res.log_prob)
        d = check_sharded(res, ref, f"mesh {shape[0]}x{shape[1]}")
        log(f"mesh {shape[0]}x{shape[1]} vs single card: max |dlogP| = {d:.3e}, "
            f"argmax orientation and displacement equal for all "
            f"{len(res.log_prob)} images [{time.perf_counter() - t0:.1f} s]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from bioem_tpu.config import use_compile_cache

    log(f"compile cache: {use_compile_cache()}")
    n_dev = 4 if args.four else 1
    card = ""

    def device_and_card():
        nonlocal card
        info = phase_device(n_dev)
        card = card_name_and_power()
        log("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
        log(card)
        return info

    phases = [("device", device_and_card)]
    if args.four:
        phases.append(("four", phase_four))
    else:
        phases += [
            ("golden", phase_golden),
            ("planted", phase_planted),
            ("e2e", lambda: phase_e2e(card=card)),
        ]
    info = None
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"=== phase {name} ===")
        try:
            out = fn()
        except Exception:
            traceback.print_exc()
            log(f"PHASE {name}: FAIL")
            return 1
        if name == "device":
            info = out
        log(f"PHASE {name}: PASS [{time.perf_counter() - t0:.1f} s]")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
