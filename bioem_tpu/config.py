"""Performance configuration (never changes results).

Mirrors the reference's environment-variable performance layer
(/root/reference/bioem.cpp:97-138, doc/index.rst:1535-1653): the reference
deliberately separates physics parameters (keyword file) from performance
knobs (env vars). Here the same split: :class:`RunConfig` holds block sizes,
precision and mesh options, overridable via ``BIOEM_TPU_*`` env vars.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import FrozenSet, Optional


@dataclass
class RunConfig:
    # Orientations processed per jitted device step (reference analogue:
    # BIOEM_PROJ_CONV_AT_ONCE, bioem.cpp:105-121).
    orient_block: int = 8
    # Images per inner scan step; 0 = all images at once.
    image_block: int = 0
    # Debug reductions (reference BIOEM_DEBUG_BREAK / BIOEM_DEBUG_NMAPS,
    # bioem.cpp:518-525, map.cpp:545-548).
    debug_break: int = 0  # cap on n_orientations and n_ctfs
    debug_nmaps: int = 0  # cap on images
    # Verbosity 0/1/2 (reference BIOEM_DEBUG_OUTPUT).
    debug_output: int = 0
    # Device mesh: images × orientations. 1×1 = single chip.
    mesh_images: int = 1
    mesh_orient: int = 1
    # Autotune block sizes before the main run. None = auto: on when the
    # problem is large enough to amortise the candidate timing runs
    # (n_orient·n_ctf·n_img ≥ run.AUTOTUNE_MIN_COMPARISONS — the analogue of
    # the reference autotuner running by default whenever GPUs are used,
    # /root/reference/autotuner.cpp:16-50). BIOEM_TPU_AUTOTUNE=0/1 forces.
    autotune: Optional[bool] = None
    # Checkpoint/resume of the streaming accumulator state (improves on the
    # reference, which restarts long runs from scratch on failure).
    checkpoint_path: str = ""
    checkpoint_every: int = 0  # orientation blocks between checkpoints
    # jax.profiler trace output dir (NVTX analogue); empty = off.
    profile_dir: str = ""
    # Projection backend: "auto" (Fourier when the model has <= 32 distinct
    # radii, else raster), "fourier", or "raster".
    projection: str = "auto"
    # Tuned fields the user pinned explicitly (env var or caller): the
    # autotuner must never override these — a cached winner replacing a
    # block size the user set would violate the reference's contract that
    # performance knobs are obeyed verbatim (doc/index.rst:1535-1653).
    forced: FrozenSet[str] = field(default_factory=frozenset)

    @classmethod
    def from_env(cls) -> "RunConfig":
        cfg = cls()
        mapping = {
            "BIOEM_TPU_ORIENT_BLOCK": "orient_block",
            "BIOEM_TPU_IMAGE_BLOCK": "image_block",
            "BIOEM_DEBUG_BREAK": "debug_break",
            "BIOEM_DEBUG_NMAPS": "debug_nmaps",
            "BIOEM_DEBUG_OUTPUT": "debug_output",
            "BIOEM_TPU_MESH_IMAGES": "mesh_images",
            "BIOEM_TPU_MESH_ORIENT": "mesh_orient",
            "BIOEM_TPU_CHECKPOINT_EVERY": "checkpoint_every",
        }
        forced = set()
        tunable = {"orient_block", "image_block"}
        for env, attr in mapping.items():
            v = os.environ.get(env)
            if v is not None:
                setattr(cfg, attr, int(v))
                if attr in tunable:
                    forced.add(attr)
        cfg.checkpoint_path = os.environ.get("BIOEM_TPU_CHECKPOINT", "")
        cfg.profile_dir = os.environ.get("BIOEM_TPU_PROFILE_DIR", "")
        cfg.projection = os.environ.get("BIOEM_TPU_PROJECTION", "auto")
        if os.environ.get("BIOEM_TPU_AUTOTUNE"):
            cfg.autotune = bool(int(os.environ["BIOEM_TPU_AUTOTUNE"]))
        cfg.forced = frozenset(forced)
        return cfg


def use_compile_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache goes to ``<checkout>/.jax_cache``: a
    fixed path, independent of the working directory, so a later process
    on the same checkout finds what an earlier one compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
