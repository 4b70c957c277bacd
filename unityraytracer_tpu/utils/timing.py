"""Per-stage timing and throughput counters.

The reference has no profiling at all (SURVEY.md aux table); this provides
the per-stage timers (build/trace/shade/accumulate) and Mrays/s counters,
plus a hook into jax.profiler for deep traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name.

    Use ``block=True`` (default) to synchronize before reading the clock so
    device work is attributed to the stage that launched it
    (``jax.block_until_ready`` on the stage's result). For per-kernel DEVICE
    time use utils/profiling.profile_stages, which parses the profiler's
    device timeline.
    """

    def __init__(self, block: bool = True):
        self.block = block
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: Optional[List] = None):
        t0 = time.perf_counter()
        yield
        if self.block and result_holder:
            jax.block_until_ready(result_holder)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16} {total*1000:9.2f} ms total "
                         f"({n}x, {total/n*1000:.2f} ms avg)")
        return "\n".join(lines)


def mrays_per_sec(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12) / 1e6


def measure_throughput(fn, *args, warmup: int = 1, iters: int = 3,
                       n_rays: Optional[int] = None):
    """Time a jitted callable; returns (best_seconds, mrays or None).

    Each call is synchronized with ``jax.block_until_ready``.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, (mrays_per_sec(n_rays, best) if n_rays else None)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
