"""Tracing/profiling helpers (SURVEY.md §5 "Tracing/profiling").

The reference has no profiling beyond manual timing; here every pipeline
stage can be annotated for the JAX profiler (visible in TensorBoard /
xprof device traces) and wall-clock scopes aggregate into the structured
metrics the benchmarks emit.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for the JAX/XLA profiler AND wall-clock stats."""
    t0 = time.perf_counter()
    with jax.named_scope(name), jax.profiler.TraceAnnotation(name):
        yield
    _SCOPES[name].append((time.perf_counter() - t0) * 1e3)


_SCOPES: dict[str, list[float]] = defaultdict(list)


def scope_stats() -> dict[str, dict]:
    out = {}
    for name, xs in _SCOPES.items():
        xs_sorted = sorted(xs)
        out[name] = {
            "count": len(xs),
            "total_ms": round(sum(xs), 3),
            "p50_ms": round(xs_sorted[len(xs) // 2], 3),
            "max_ms": round(xs_sorted[-1], 3),
        }
    return out


def reset_scopes() -> None:
    _SCOPES.clear()


def dump_metrics(path: str, extra: dict | None = None) -> None:
    """Write structured per-run metrics JSON (BASELINE.md headline format)."""
    payload = {"scopes": scope_stats()}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def start_trace(logdir: str) -> None:
    """Capture a full device trace (open in TensorBoard's profile plugin)."""
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
