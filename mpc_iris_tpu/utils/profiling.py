"""Profiling & tracing — the auxiliary subsystem the reference lacks.

The reference relies on external `samply` sampling with a dedicated cargo
profile (Cargo.toml:52-56) and has no built-in tracing. Here we get device-level
tracing from jax.profiler (XLA op timeline and device memory in
TensorBoard / Perfetto) plus lightweight host-side stage timers.

Usage:
    with device_trace("/tmp/trace"):        # view with tensorboard / perfetto
        engine.match(q, m)

    timers = StageTimers()
    with timers.stage("encode"): ...
    with timers.stage("matmul"): ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(log_dir: str, host_tracer_level: int = 2):
    """jax.profiler trace context; writes a TensorBoard/Perfetto trace."""
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up on the device timeline (TraceAnnotation)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def device_memory_stats(device=None) -> dict:
    """Best-effort HBM usage for one device (bytes)."""
    import jax

    dev = device or jax.devices()[0]
    try:
        stats = dev.memory_stats() or {}
    except Exception:
        stats = {}
    return {
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }


class StageTimers:
    """Accumulating named stage timers for host-side pipeline stages
    (== the reference's indicatif per-stage bars, src/main.rs:178-183)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.totals[name] += time.monotonic() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values()) or 1e-9
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:24s} {t:9.3f}s  {100 * t / total:5.1f}%  "
                f"x{self.counts[name]}"
            )
        return "\n".join(lines)
