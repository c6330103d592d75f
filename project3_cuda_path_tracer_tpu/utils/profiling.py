"""Tracing / profiling subsystem (SURVEY §5.1).

The reference has no profiling beyond per-stage cudaDeviceSynchronize points
(src/pathtrace.cu:356) and a stale timing artifact (img/stacked_bar_graph.png).
Here: `jax.profiler` trace capture (XProf/Perfetto-compatible), named scopes
on pipeline stages, and a simple stage-timing harness for the A/B
experiments the scaffold prescribes (sorted-vs-not, compacted-vs-not,
src/pathtrace.cu:313-317,366-367).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in XProf/TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def named(name: str):
    """Annotate a trace span (shows up in the profiler timeline)."""
    return jax.named_scope(name)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> float:
    """Wall-clock one jitted callable (seconds/call), each call waited
    for with ``jax.block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters


def ab_compare(variants: Dict[str, Callable], iters: int = 10) -> Dict[str, float]:
    """Run each named thunk and report seconds/call — the scaffold's A/B
    methodology as a reusable harness."""
    return {name: time_fn(fn, iters=iters) for name, fn in variants.items()}
