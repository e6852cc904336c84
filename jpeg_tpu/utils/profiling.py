"""Profiling and metrics utilities.

SURVEY.md §5: the reference has no tracing/metrics at all (ad-hoc println
only, ``src/jpeg/huffman.rs:153-154``). Here: stage timers with JSON export,
roofline counters (bytes moved / FLOPs per stage), and a jax.profiler trace
context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import time


class StageTimer:
    """Accumulates wall-clock per named stage + derived rates."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.meta: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if meta:
                m = self.meta.setdefault(name, {})
                for k, v in meta.items():
                    m[k] = m.get(k, 0) + v

    def report(self) -> dict:
        out = {}
        for name, total in self.totals.items():
            entry = {
                "total_s": round(total, 6),
                "calls": self.counts[name],
                "mean_ms": round(1000 * total / self.counts[name], 3),
            }
            m = self.meta.get(name, {})
            if "bytes" in m and total > 0:
                entry["GB_per_s"] = round(m["bytes"] / total / 1e9, 3)
            if "flops" in m and total > 0:
                entry["GFLOP_per_s"] = round(m["flops"] / total / 1e9, 3)
            if "frames" in m and total > 0:
                entry["frames_per_s"] = round(m["frames"] / total, 2)
            out[name] = entry
        return out

    def dump(self, path=None) -> str:
        s = json.dumps(self.report(), indent=2, sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """jax.profiler trace context (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
