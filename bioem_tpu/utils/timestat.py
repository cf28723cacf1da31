"""Per-phase wall-clock statistics (mean ± σ) and profiler hooks.

JAX equivalent of the reference's ``HighResTimer``/``TimeStat``
(/root/reference/timer.cpp:23-165, include/timer.h:27-94) and its NVTX
ranges (/root/reference/bioem.cpp:53-91): the engine's setup and per-block
step times are collected here and summarised like the reference's
end-of-run phase table; ``profile_trace`` wraps a region in a
``jax.profiler`` trace (the NVTX analogue — view with TensorBoard/XProf).

The reference's separate projection/convolution/comparison phases are fused
into one compiled block step (that fusion *is* the optimisation), so the
phase granularity is: SETUP (host precompute + compile), BLOCK (one
orientation-block step), REDUCE (final collective + host readback).
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class TimeStat:
    """Accumulates named phase durations; prints a mean±σ summary."""

    phases: Dict[str, List[float]] = field(default_factory=dict)

    def add(self, phase: str, seconds: float) -> None:
        self.phases.setdefault(phase, []).append(seconds)

    @contextlib.contextmanager
    def time(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, time.perf_counter() - t0)

    def summary(self) -> str:
        """Reference timer.cpp:156-165 format: phase, total, mean, σ."""
        lines = ["\tTime statistics:"]
        for phase, vals in self.phases.items():
            n = len(vals)
            mean = sum(vals) / n
            var = sum((v - mean) ** 2 for v in vals) / n
            lines.append(
                f"\t\t{phase:<12} total {sum(vals):10.4f}s  "
                f"mean {mean:9.5f}s  stdev {math.sqrt(var):9.5f}s  (n={n})"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """jax.profiler trace region (NVTX analogue). No-op when dir is empty."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
