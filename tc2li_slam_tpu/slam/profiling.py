"""Per-stage timing statistics + device tracing hooks.

The reference instruments its frame path with ``#ifdef REGISTER_TIMES``
chrono vectors and prints mean/std per stage at shutdown
(``Tracking::PrintTimeStats``, Tracking.cc:302-573 — which, notably, no
longer compiles there; SURVEY §5). This module is the working equivalent:

- ``StageTimer``: named wall-clock accumulators with mean/σ/max reporting.
  In the async-dispatch design most stages enqueue work and return
  immediately, so stage timings measure HOST cost; the per-frame ``sync``
  stage (the one blocking fetch) absorbs device latency and is the
  throughput-relevant number.
- ``device_trace``: context manager around ``jax.profiler`` tracing for
  per-kernel device profiles (an ``.xplane.pb`` under ``log_dir``, read by
  TensorBoard / xprof or ``jax.profiler.ProfileData``).
"""

from __future__ import annotations

import contextlib
import math
import os
import subprocess
import time
from collections import defaultdict

# Verbose inertial-ladder / reset decisions (TC2LI_DEBUG_VI=1): the staged
# VI init runs rarely and data-dependently — when it silently declines to
# fire, this is the cheapest way to see why.
DEBUG_VI = os.environ.get("TC2LI_DEBUG_VI") == "1"


def _device_flush():
    """Block until all previously enqueued device work has finished.

    XLA runs a device's programs in dispatch order, so blocking on a fresh
    trivial computation flushes everything dispatched before it."""
    import jax
    import jax.numpy as jnp

    jnp.zeros(()).block_until_ready()


class StageTimer:
    """Accumulates per-stage durations; prints a PrintTimeStats-style report.

    With ``TC2LI_SYNC_STAGES=1`` every stage exit blocks until the device
    queue drains, so stage timings become honest per-stage DEVICE times
    (at the cost of killing async pipelining — profiling mode only).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.sync = bool(os.environ.get("TC2LI_SYNC_STAGES"))
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        if self.sync:
            _device_flush()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _device_flush()
            self.samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        if self.enabled:
            self.samples[name].append(seconds)

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            n = len(xs)
            mean = sum(xs) / n
            var = sum((x - mean) ** 2 for x in xs) / n if n > 1 else 0.0
            out[name] = {
                "n": n,
                "mean_ms": mean * 1e3,
                "std_ms": math.sqrt(var) * 1e3,
                "max_ms": max(xs) * 1e3,
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        """Formatted table (the PrintTimeStats analog)."""
        lines = [f"{'stage':<24}{'n':>6}{'mean ms':>10}{'std':>8}{'max':>9}{'total s':>9}"]
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name:<24}{s['n']:>6}{s['mean_ms']:>10.2f}{s['std_ms']:>8.2f}"
                f"{s['max_ms']:>9.1f}{s['total_s']:>9.2f}"
            )
        return "\n".join(lines)

    def reset(self):
        self.samples.clear()


def card_line() -> str:
    """The GPUs' names and power limits as ``nvidia-smi`` reports them, one
    line per card; a card set below its maximum runs slower under load, so
    this goes beside every timing. A child process, not JAX, reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed region on the host and the device into
    ``log_dir`` (``jax.profiler.start_trace``/``stop_trace``)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
