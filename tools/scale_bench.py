"""BASELINE configs 2-3: production-scale orientation grids on one card.

Runs the bench problem (224² pixels, 64 images, 8 CTFs, 21×21 displacement
lattice) at 4608 and 36864 Super-Fibonacci orientations (the reference ships
exactly these list sizes in /root/reference/Quaternions/ and documents the
4608×32-CTF production run at doc/index.rst:2097-2132), each with and
without WRITE_PROB_ANGLES, and reports comparisons/s + peak HBM.

The per-angle path (WRITE_PROB_ANGLES) adds an (I, n_orient) f64 ×2 slab to
the streamed state, updated per block with dynamic_update_slice — this run
verifies the slab update does not collapse throughput at 36864 orientations.

Usage: python tools/scale_bench.py [n_orient ...]   (default: 4608 36864)
Emits one JSON line per config; appends results to BENCH_SCALE.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_IMG = int(os.environ.get("BENCH_NIMG", 64))
REPEATS = int(os.environ.get("BENCH_REPEATS", 2))


def build(n_orient: int, write_angles: int):
    from bench import build_problem
    from bioem_tpu.core.orientations import OrientationSet
    from bioem_tpu.utils.so3 import super_fibonacci

    p, _, model, images = build_problem()
    p.write_angles = write_angles
    q = super_fibonacci(n_orient).astype(np.float64)
    orients = OrientationSet(
        angles=q, use_quaternions=True, voluang=1.0 / n_orient, priors=None
    )
    return p, orients, model, images


def peak_hbm_mb():
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats()
        return round(stats.get("peak_bytes_in_use", 0) / 2**20, 1)
    except Exception:
        return None


def run_one(n_orient: int, write_angles: int):
    import jax

    from bioem_tpu.config import RunConfig
    from bioem_tpu.run import make_engine

    p, orients, model, images = build(n_orient, write_angles)
    cfg = RunConfig.from_env()
    cfg.autotune = False  # isolate scale behaviour from tuner choices
    eng = make_engine(p, orients, model, images, cfg)
    jax.block_until_ready(eng.run().total)  # warmup
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state = eng.run()
        jax.block_until_ready(state.total)
        best = min(best, time.perf_counter() - t0)
    comparisons = eng.n_orient * eng.n_ctf * eng.n_img
    rec = {
        "n_orient": n_orient,
        "write_prob_angles": bool(write_angles),
        "comparisons": comparisons,
        "seconds": round(best, 2),
        "comparisons_per_s": round(comparisons / best, 1),
        "peak_hbm_mb": peak_hbm_mb(),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [4608, 36864]
    out = []
    for n in sizes:
        for wa in (0, 30):
            out.append(run_one(n, wa))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BENCH_SCALE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
