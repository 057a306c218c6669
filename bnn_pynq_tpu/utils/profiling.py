"""Profiling helpers (SURVEY.md §5.1 rebuild: jax.profiler traces +
steady-state timing that ends in `jax.block_until_ready`)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Wrap a region in a jax.profiler trace viewable in TensorBoard/xprof."""
    if not enabled:
        yield
        return
    import jax
    os.makedirs(log_dir, exist_ok=True)
    with jax.profiler.trace(log_dir):
        yield


def steady_state_time(launch: Callable[[], object], iters: int = 20,
                      warmup: int = 2) -> float:
    """Seconds per launch: `iters` async launches back to back, timed to
    the completion of the last (`jax.block_until_ready`)."""
    return steady_state_stats(launch, iters=iters, repeats=1,
                              warmup=warmup)[0]


def steady_state_stats(launch: Callable[[], object], iters: int = 20,
                       repeats: int = 4, warmup: int = 2):
    """(median, half_range) seconds/launch over `repeats` windows of
    `iters` launches each, every window ending in block_until_ready."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(launch())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        outs = [launch() for _ in range(iters)]
        jax.block_until_ready(outs)
        ts.append((time.perf_counter() - t0) / iters)
    ts.sort()
    return ts[len(ts) // 2], (ts[-1] - ts[0]) / 2
