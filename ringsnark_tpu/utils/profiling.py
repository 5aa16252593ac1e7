"""Tracing / profiling / observability.

The reference has no framework (manual chrono in microbench.cpp, fossilized
libff blocks — SURVEY §5).  Here: structured timers, jax profiler traces, and
per-kernel roofline estimates for the NTT.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

import jax

__all__ = ["timer", "Timings", "trace", "ntt_roofline", "log"]

log = logging.getLogger("ringsnark_tpu")


class Timings:
    """Accumulates named wall-clock timings; printable as a table or JSON."""

    def __init__(self):
        self.records: dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.records[name] = self.records.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def as_json(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.records.items()})

    def __repr__(self):
        width = max((len(k) for k in self.records), default=4)
        lines = [f"{k:<{width}}  {v*1e3:10.3f} ms" for k, v in self.records.items()]
        return "\n".join(lines)


@contextlib.contextmanager
def timer(name: str, sync=None):
    """Log a single timing at INFO level."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        log.info("[TIME] %s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace (open with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def ntt_roofline(N: int, L: int, batch: int, seconds: float) -> dict:
    """Rough roofline numbers for a batched negacyclic NTT run.

    Counts ~one 32-bit modmul + add + sub per butterfly.  Bytes: `min_bytes`
    reads and writes the uint32 data once (the fused kernel's traffic);
    `plain_bytes` reads and writes it once per stage (the plain path's).
    """
    import math

    stages = int(math.log2(N))
    butterflies = batch * L * N // 2 * stages
    # per butterfly: 1 mulmod (~10 int ops w/ Shoup or Barrett) + add + sub
    int_ops = butterflies * 12
    min_bytes = batch * L * N * 4 * 2
    return {
        "butterflies": butterflies,
        "int_ops": int_ops,
        "int_ops_per_s": int_ops / seconds,
        "min_bytes": min_bytes,
        "plain_bytes": min_bytes * stages,
    }
