"""Timing and profiling harness.

The reference's observability is wall-clock-only `elapsed_ms` fields
(engine/app.py:155-156; verify.py:33-39) — SURVEY.md §5.1. This framework
keeps that contract at the API layer and adds the device-accurate pieces the
reference cannot have:

- `device_timer`: wall timing that `block_until_ready()`s its result, so
  async dispatch doesn't fake sub-ms latencies.
- `benchmark`: warmup + repeated timed calls, min/median/mean.
- `trace`: a `jax.profiler` trace context writing a TensorBoard-loadable
  profile (kernel-level visibility: per-op device time).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


def _sync(x):
    """Wait for every array in a pytree result (async dispatch would
    otherwise fake sub-ms latencies)."""
    return jax.block_until_ready(x)


@contextlib.contextmanager
def device_timer(label: str = "", results: dict | None = None):
    """Context manager yielding a dict that receives `elapsed_ms` after the
    body; call `sync(x)` on any device values the body produced first."""
    record: Dict[str, float] = {}
    start = time.perf_counter()
    yield record
    record["elapsed_ms"] = round((time.perf_counter() - start) * 1000, 3)
    if results is not None:
        results[label] = record["elapsed_ms"]


def timed_call(fn: Callable, *args, **kwargs):
    """(result, elapsed_ms) with a device sync before the clock stops."""
    start = time.perf_counter()
    out = _sync(fn(*args, **kwargs))
    return out, (time.perf_counter() - start) * 1000.0


def benchmark(fn: Callable, *args, warmup: int = 1, trials: int = 5,
              **kwargs) -> Dict[str, float]:
    """Compile-excluded repeated timing; returns ms statistics."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(trials):
        _, ms = timed_call(fn, *args, **kwargs)
        times.append(ms)
    times.sort()
    return {
        "min_ms": times[0],
        "median_ms": times[len(times) // 2],
        "mean_ms": sum(times) / len(times),
        "trials": trials,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope (open with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
