"""Block-size autotuner.

JAX analogue of the reference autotuner (BioEM autotuner.cpp:16-149,
defs.h:188-202): the reference tunes one scalar — the GPU/CPU workload split
— by bisection on comparison timings. Here the whole comparison runs on the
device, so there is no host/device split; the tunable is the orientation
block size. The search is a timed argmin over a small candidate set,
measured on the real problem's first orientation blocks (compile time
excluded, like the reference's ``Needed``/``stable`` warmup logic at
autotuner.cpp:35-50).
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import List, Optional, Sequence

import jax
import numpy as np

from ..config import RunConfig


# Tuned fields persisted across processes (each candidate costs a compile;
# re-timing an already-tuned shape is waste — the reference amortises the
# same way by recalibrating only every RECALIB_FACTOR=200 projections,
# defs.h:197-202). Entries may hold other keys (fields of older versions):
# only these are applied.
_CACHED_FIELDS = ("orient_block", "image_block")


def _cache_path() -> str:
    return os.environ.get(
        "BIOEM_TPU_AUTOTUNE_CACHE", os.path.join(os.getcwd(), ".bioem_tpu_autotune.json")
    )


def _bucket(n: int) -> int:
    """Round to the NEAREST power of two (ratio distortion ≤ √2): the tuned
    winner depends on shape *scale*, not exact counts — bucketing lets a
    production run with 4500 images reuse the entry tuned at 4096 instead
    of re-paying the candidate compiles (exact-count keys never hit in
    production; round-UP would put 4097..8192 in a different bucket than
    the 4096 the bench tunes at)."""
    n = max(int(n), 1)
    hi = 1 << (n - 1).bit_length()
    lo = max(hi // 2, 1)
    return lo if n * n <= lo * hi else hi


def _cache_key(p, n_orient: int, n_img: int, cfg=None) -> str:
    kind = jax.devices()[0].device_kind if jax.devices() else "cpu"
    forced = ""
    mesh = ""
    if cfg is not None and cfg.forced:
        # Forced knobs change which candidates are comparable — fold them
        # into the key so a forced run never poisons the free-tuning entry.
        forced = "|F" + ",".join(
            f"{f}={getattr(cfg, f)}" for f in sorted(cfg.forced)
        )
    if cfg is not None and cfg.mesh_images * cfg.mesh_orient != 1:
        # Per-shard shapes differ from the single-chip case; a mesh run must
        # never reuse (or poison) the single-chip entry.
        mesh = f"|M{cfg.mesh_images}x{cfg.mesh_orient}"
    # BIOEM_DEBUG_BREAK caps n_ctf as well as n_orient (engine.py) — the
    # key must reflect the CTF count actually run, or a debug-capped tune
    # poisons the production entry.
    n_ctf = p.n_ctf
    if cfg is not None and cfg.debug_break:
        n_ctf = min(n_ctf, cfg.debug_break)
    return (
        f"{kind}|N{p.n_pixels}|D{p.nx_disp}|s{p.grid_space_center}"
        f"|C{n_ctf}|I{_bucket(n_img)}|O{_bucket(n_orient)}{mesh}{forced}"
    )


def _cache_load(key: str) -> Optional[dict]:
    try:
        with open(_cache_path()) as f:
            entry = json.load(f).get(key)
    except (OSError, ValueError):
        return None
    if entry is None:
        return None
    return {k: v for k, v in entry.items() if k in _CACHED_FIELDS}


def _cache_store(key: str, fields: dict) -> None:
    path = _cache_path()
    try:
        data = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}  # unreadable cache = start fresh, never abort a run
        data[key] = fields
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except (OSError, ValueError):
        pass  # cache is an optimisation only


def default_candidates(cfg: RunConfig) -> List[RunConfig]:
    """Shape-independent candidate set (reference analogue: the
    autotuner's bisection domain, autotuner.cpp:118-149): the orientation
    block, unless the user pinned it. Each candidate costs a compile, so
    the set is kept small."""
    o_blocks = (cfg.orient_block,) if "orient_block" in cfg.forced else (4, 8, 16)
    return [replace(cfg, autotune=False, orient_block=o) for o in o_blocks]


def autotune_config(
    p,
    orients,
    model,
    images,
    cfg: RunConfig,
    candidates: Optional[Sequence[RunConfig]] = None,
    blocks: Optional[int] = None,
    repeats: int = 2,
    verbose: bool = False,
) -> RunConfig:
    """Pick the fastest RunConfig by timing real block steps per candidate.

    Results are cached per (device kind, problem shape) in
    ``.bioem_tpu_autotune.json`` (override with BIOEM_TPU_AUTOTUNE_CACHE;
    set it to /dev/null to disable) — a second run of the same shape reuses
    the recorded winner instead of re-compiling every candidate.
    """
    from ..run import make_engine

    # Tune at the shape the engine will actually run (debug caps applied) —
    # keying/tuning on the uncapped shape would poison the production cache
    # entry with a winner measured on a reduced problem.
    n_orient = min(orients.n, cfg.debug_break) if cfg.debug_break else orients.n
    n_img = images.maps.shape[0]
    if cfg.debug_nmaps:
        n_img = min(n_img, cfg.debug_nmaps)
    key = _cache_key(p, n_orient, n_img, cfg)
    cached = _cache_load(key)
    if cached is not None:
        # Never override knobs the user pinned explicitly (cfg.forced).
        cached = {k: v for k, v in cached.items() if k not in cfg.forced}
        if verbose:
            print(f"autotune: cached config for {key}: {cached}")
        return replace(cfg, autotune=False, **cached)
    candidates = (
        list(candidates) if candidates is not None else default_candidates(cfg)
    )
    best_cfg, best_t = cfg, float("inf")
    for cand in candidates:
        try:
            eng = make_engine(p, orients, model, images, cand)
        except Exception as e:  # incompatible candidate
            if verbose:
                print(f"autotune: skip {cand}: {e}")
            continue
        # Same orientation span for every candidate (blocks is in units of
        # the baseline cfg.orient_block), so the single scan-dispatch cost
        # amortises identically across different block sizes. time_blocks
        # times the jitted SCAN (the production run path; the sharded
        # engine times its shard_map'd scan) — see BioEMEngine.time_blocks.
        # Default probe span: ~1024 orientations, so that the per-dispatch
        # cost and its jitter stay well below the ~10% differences between
        # candidates.
        target_orients = (
            blocks * max(cfg.orient_block, 1)
            if blocks is not None
            else min(1024, n_orient)
        )
        try:
            t_cand = eng.time_blocks(target_orients, repeats=repeats)
        except Exception as e:  # compile/measure failure (OOM, lowering)
            # must not abort the production run — the candidate just loses
            if verbose:
                print(f"autotune: candidate failed during timing: {e}")
            continue
        if verbose:
            print(
                f"autotune: o_block={cand.orient_block}: "
                f"{t_cand*1e3:.3f} ms/orientation"
            )
        if t_cand < best_t:
            best_t, best_cfg = t_cand, cand
    if np.isfinite(best_t):
        # Only persist a *timed* winner: if every candidate failed — e.g. a
        # transient OOM — the untuned fallback must not become the cached
        # answer for this shape forever.
        _cache_store(key, {f: getattr(best_cfg, f) for f in _CACHED_FIELDS})
    return best_cfg
