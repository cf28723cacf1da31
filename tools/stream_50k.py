"""BASELINE config-5 image scale on ONE card: 50k × 224² images, streamed.

The full conj-FFT image bank for 50k 224² particles is ~10 GB (plus cc
intermediates) — more than this problem should hold on one card.
The streaming mode (bioem_tpu/stream.py, reference analogue: GPU image
chunking nTotParallelMaps=1024, /root/reference/map.cpp:549 defs.h:182)
holds only one chunk's banks on device at a time, so the 50k set runs on
one card without OOM.

Images are synthesised lazily per chunk (seeded by chunk index) — the host
never materialises the 10 GB stack either. Orientation count is kept small
(the image axis is what's under test; scale orientations with
tools/scale_bench.py).

Usage: python tools/stream_50k.py [n_images] [chunk] [--mesh IxO]
(defaults: 50000 1024, no mesh). ``--mesh 2x4`` streams every chunk
through a 2×4 (img × orient) device mesh — the full BASELINE config-5
composition (streaming × sharding; add the multi-host env for × hosts).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


class SyntheticSource:
    """Lazy ImageSource: chunk (start, stop) is generated on demand."""

    def __init__(self, n_images: int, n_pixels: int):
        self._n = n_images
        self._npix = n_pixels

    @property
    def n_images(self) -> int:
        return self._n

    def chunk(self, start: int, stop: int) -> np.ndarray:
        rng = np.random.default_rng(start)
        return rng.normal(
            0, 1, (stop - start, self._npix, self._npix)
        ).astype(np.float32)


def main():
    args = list(sys.argv[1:])
    mesh_shape = None
    if "--mesh" in args:
        i = args.index("--mesh")
        mesh_shape = tuple(int(v) for v in args[i + 1].split("x"))
        del args[i:i + 2]
    n_images = int(args[0]) if len(args) > 0 else 50_000
    chunk = int(args[1]) if len(args) > 1 else 1024

    from bench import build_problem
    from bioem_tpu.config import RunConfig
    from bioem_tpu.core.orientations import OrientationSet
    from bioem_tpu.stream import run_streaming
    from bioem_tpu.utils.so3 import super_fibonacci

    p, _, model, _ = build_problem()
    # Default 4608 (the reference's production list size,
    # doc/index.rst:2097-2132): at 64 orientations the per-chunk fixed scan
    # cost dominates and the streamed rate underclaims the engine by ~100×
    # (round-3 BENCH_STREAM lesson) — a production grid amortises it.
    n_orient = int(os.environ.get("BENCH_NORIENT", 4608))
    q = super_fibonacci(n_orient).astype(np.float64)
    orients = OrientationSet(
        angles=q, use_quaternions=True, voluang=1.0 / n_orient, priors=None
    )
    cfg = RunConfig.from_env()
    cfg.autotune = False
    if mesh_shape is not None:
        from bioem_tpu.parallel.distributed import initialize

        initialize()  # no-op single-host
        cfg.mesh_images, cfg.mesh_orient = mesh_shape
    src = SyntheticSource(n_images, p.n_pixels)
    t0 = time.perf_counter()
    results, perf = run_streaming(
        p, orients, model, src, cfg, chunk_images=chunk, progress=True
    )
    wall = time.perf_counter() - t0
    assert results.log_prob.shape == (n_images,)
    assert np.isfinite(results.log_prob).all()
    peak = None
    try:
        import jax

        peak = round(
            jax.local_devices()[0].memory_stats()["peak_bytes_in_use"] / 2**20, 1
        )
    except Exception:
        pass
    print(json.dumps({
        "n_images": n_images,
        "mesh": list(mesh_shape) if mesh_shape else [1, 1],
        "n_orient": n_orient,
        "n_ctf": p.n_ctf,
        "chunk_images": chunk,
        "comparisons": perf["comparisons"],
        "device_s": round(perf["run_s"], 1),
        "wall_s": round(wall, 1),
        "comparisons_per_s_device_loop": round(
            perf["comparisons"] / perf["run_s"], 1
        ),
        "peak_hbm_mb": peak,
    }))


if __name__ == "__main__":
    main()
