"""Phase timers and device traces.

Counterpart of `progressivecodec_tpu/utils/profiling.py`.  `PhaseTimer`
accumulates host-clock time per named phase; a phase given a CUDA tensor
as `sync` waits for its device before the clock stops, so the span covers
the queued device work.  `device_trace` records a `torch.profiler` trace
(CPU activity, and CUDA activity when a card is present) and writes it to
`log_dir` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulating per-phase wall timers with a device sync at the end of
    each phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: torch.Tensor | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.device.type == "cuda":
                torch.cuda.synchronize(sync.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "n": self.counts[k], "mean_s": self.totals[k] / self.counts[k]}
            for k in self.totals
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block and write `log_dir/trace.json` (Chrome trace
    format; open it in chrome://tracing or Perfetto).  Yields the profiler,
    whose `key_averages()` sums the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
