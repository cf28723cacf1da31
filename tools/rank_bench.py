"""BASELINE config 4 evidence: multi-model ranking amortisation.

Ranks N candidate models against one image set twice:

* **reuse** (production path, rank_models): ONE engine — image FFT bank,
  orientation blocks and the compiled step are built once, each further
  candidate only swaps model arrays in (common padded layout, zero
  retracing). Reference analogue: the MODEL_COMPARISON workflow runs one
  full BioEM invocation per model (doc/index.rst:2290-2521), re-reading and
  re-FFT-ing the particle set every time.
* **naive estimate**: the first model's cold time (engine build + compile +
  run) × N — what N independent invocations would cost.

Emits one JSON line and appends to BENCH_RANK.json. The images are random
(throughput evidence; ranking *correctness* is pinned by
tests/test_stream_rank.py and the golden suite).

Usage: python tools/rank_bench.py [n_models] [n_images] [n_orient]
(defaults: 10 1000 576)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n_models = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    n_images = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    n_orient = int(sys.argv[3]) if len(sys.argv) > 3 else 576


    from bench import build_problem
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.orientations import OrientationSet
    from bioem_tpu.io.map_io import ImageStack
    from bioem_tpu.io.model_io import Model
    from bioem_tpu.rank import common_model_layout
    from bioem_tpu.run import make_engine
    from bioem_tpu.utils.so3 import super_fibonacci

    import jax

    p, _, model0, _ = build_problem()
    q = super_fibonacci(n_orient).astype(np.float64)
    orients = OrientationSet(
        angles=q, use_quaternions=True, voluang=1.0 / n_orient, priors=None
    )
    rng = np.random.default_rng(7)
    images = ImageStack(
        rng.normal(0, 1, (n_images, p.n_pixels, p.n_pixels)).astype(np.float32)
    )
    # Candidates: model 0 plus perturbed copies (same point count — the
    # common layout padding is exercised by tests with heterogeneous models).
    models = [model0]
    for _ in range(n_models - 1):
        pts = model0.points + rng.normal(0, 0.8, model0.points.shape).astype(
            np.float32
        )
        models.append(
            Model(pts, model0.radii, model0.densities, model0.norm_den)
        )

    cfg = RunConfig.from_env()
    cfg.autotune = False
    layout = common_model_layout(p, models, cfg.projection)

    t0 = time.perf_counter()
    eng = make_engine(p, orients, models[0], images, cfg, model_layout=layout)
    state = eng.run()
    jax.block_until_ready(state.total)
    np.asarray(state.total)
    t_cold = time.perf_counter() - t0  # build + compile + first run

    t_swaps = []
    totals = [float(np.log(np.asarray(state.total)).sum())]
    for m in range(1, n_models):
        t0 = time.perf_counter()
        banks = eng.swap_model(models[m])
        state = eng.run(banks=banks)
        jax.block_until_ready(state.total)
        np.asarray(state.total)
        t_swaps.append(time.perf_counter() - t0)
        totals.append(float(np.log(np.asarray(state.total)).sum()))

    reuse_s = t_cold + sum(t_swaps)
    naive_s = n_models * t_cold
    comparisons = n_models * eng.n_orient * eng.n_ctf * eng.n_img
    rec = {
        "n_models": n_models,
        "n_images": n_images,
        "n_orient": n_orient,
        "cold_s": round(t_cold, 2),
        "mean_swap_run_s": round(float(np.mean(t_swaps)), 3),
        "reuse_total_s": round(reuse_s, 2),
        "naive_estimate_s": round(naive_s, 2),
        "speedup_vs_naive": round(naive_s / reuse_s, 2),
        "comparisons_per_s_reuse": round(comparisons / reuse_s, 1),
    }
    print(json.dumps(rec), flush=True)
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BENCH_RANK.json",
    )
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
