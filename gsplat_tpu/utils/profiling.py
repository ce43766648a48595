"""Profiling + metrics harness.

The reference has no tracing/profiling at all (SURVEY.md §5).  This provides
the observability layer: ``jax.profiler`` trace annotations around
pipeline phases, a wall-clock phase timer, and the frames/sec measurement
harness used by ``bench.py`` and the BASELINE metrics.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, List, Optional

import jax


@contextlib.contextmanager
def trace_span(name: str):
    """jax.profiler annotation visible in TensorBoard/xprof traces."""
    with jax.profiler.TraceAnnotation(name):
        yield


class PhaseTimer:
    """Accumulates wall-clock stats per named phase (host-side)."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            out[name] = {
                "count": len(xs),
                "median_ms": statistics.median(xs) * 1e3,
                "mean_ms": statistics.fmean(xs) * 1e3,
                "min_ms": min(xs) * 1e3,
                "max_ms": max(xs) * 1e3,
            }
        return out


def measure_fps(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 3,
) -> Dict[str, float]:
    """Median frames/sec of a jitted callable (blocks on the output)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return {"fps": 1.0 / dt, "median_ms": dt * 1e3, "iters": iters}


def start_trace(logdir: str) -> None:
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
