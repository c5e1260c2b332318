"""Tracing / profiling subsystem (SURVEY.md §5 row 'tracing/profiling').

The reference's observability is a `timeit` decorator and ad-hoc
`time.time()` prints (`/root/reference/preprocess/utils.py:31-43`,
`CoverAlgorithm.py:159-293`). The replacement here has two layers:

- `device_trace(logdir)`: a `jax.profiler.trace` capture (XPlane /
  perfetto + TensorBoard format) of everything inside the context —
  kernel timelines, HLO cost attribution, host/device overlap. Tile
  dispatches inside the sweep carry `StepTraceAnnotation`s so the trace
  is navigable tile by tile.

- `stages`: a process-global wall-clock accumulator for coarse pipeline
  stages (extract / sweep / eval / checkpoint ...). Device work is
  asynchronous, so stages that end in device values should pass them to
  `block()` to be counted where they are actually spent. Enabled by the
  CLI's `--stage-times` (and always cheap: two perf_counter calls when
  disabled).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimes:
    """Accumulating per-stage wall timings.

    Gated by `enabled` (set by the CLI's --stage-times and by the bench
    scripts): when off, stage() is a no-op context so non-profiled runs
    pay nothing per stage."""

    def __init__(self):
        self.enabled = False
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def reset(self):
        self.total.clear()
        self.count.clear()

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    @staticmethod
    def block(value):
        """Wait for device values so the enclosing stage's time includes
        their execution (jax dispatch is asynchronous)."""
        return jax.block_until_ready(value)

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k, _ in rows), default=5)
        lines = [f"{'stage':<{width}}  {'total_s':>9}  {'calls':>7}  "
                 f"{'per_call_ms':>11}"]
        for k, t in rows:
            n = self.count[k]
            lines.append(f"{k:<{width}}  {t:>9.3f}  {n:>7}  "
                         f"{1000 * t / max(n, 1):>11.2f}")
        return "\n".join(lines)


#: process-global stage collector (the CLI enables + prints it)
stages = StageTimes()


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """Capture a jax.profiler trace into `logdir` (no-op when None).
    View with TensorBoard's profile plugin or ui.perfetto.dev."""
    if not logdir:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


def step_annotation(name: str, **kwargs):
    """A `jax.profiler.StepTraceAnnotation` (labels one sweep tile /
    batch inside a device_trace capture)."""
    return jax.profiler.StepTraceAnnotation(name, **kwargs)
