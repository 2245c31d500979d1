"""Profiling / tracing utilities.

Device counterpart of the reference's perf_event wrapper
(linux/linux-perf-events.h): captures JAX profiler traces viewable in
Perfetto / TensorBoard, plus a lightweight section timer."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a device trace around a block:

        with profiling.trace("traces/flagstat"):
            fn(x).block_until_ready()

    Open the resulting directory with TensorBoard or ui.perfetto.dev."""
    import jax

    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(logdir))
    try:
        yield str(logdir)
    finally:
        jax.profiler.stop_trace()


class SectionTimer:
    """Accumulating named wall-clock sections (host-side pipeline stages)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total*1e3:.2f} ms total, {n} calls, "
                         f"{total/n*1e6:.1f} us/call")
        return "\n".join(lines)
