"""Profiling hooks (``scamlgp_tpu/utils/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler`` that records
  the host and, where there is one, the card, and writes a Chrome trace
  (``trace.json``) into ``dir``; it yields the profiler, whose
  ``key_averages()`` sums the time by operator and kernel.
- ``Timer`` / ``GLOBAL_TIMER``: an accumulating wall-clock registry of named
  phases, reportable as one dict.  A phase given a CUDA device synchronizes
  the current stream of that device before its clock is read, where the
  reference blocks on its results, so a phase's time includes the device
  work that it queued.  Threads may time phases at once
  (``parallel.mesh.run_slots``): each waits on its own stream only.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch

logger = logging.getLogger("scamlgp_tpu_torch")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with profiling.trace('prof') as prof: ...``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def synchronize(device) -> None:
    """Wait for the work queued on the current stream of ``device`` where it
    is a CUDA device: all of the caller's work, and none of another
    thread's stream."""
    if _is_cuda(device):
        torch.cuda.current_stream(device).synchronize()


def capturing(device) -> bool:
    """Whether ``device`` is a CUDA device whose current stream is being
    captured into a CUDA graph."""
    if not _is_cuda(device):
        return False
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


class Timer:
    """Accumulating wall-clock timer keyed by phase name.

    A phase adds the wall time of the thread that ran it.  The campaign's
    ``campaign_*`` stages run in the caller's thread, so they stay its wall
    time; the ``iteration_*`` stages run in each study row's own thread
    (``run_slots``), so once rows overlap their totals are the sum of every
    row's time in the stage, which may exceed the wall time.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str, device=None):
        """Time the block as phase ``name``; with a CUDA ``device``, the
        device is synchronized before the clock is read at the end.  Under
        a CUDA graph capture on ``device`` nothing is synchronized or
        recorded."""
        if capturing(device):
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(device)
            seconds = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += seconds
                self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"total_s": self.totals[k], "count": self.counts[k],
                        "mean_s": self.totals[k] / max(self.counts[k], 1)}
                    for k in sorted(self.totals)}

    def log(self, level: int = logging.INFO) -> None:
        logger.log(level, "phase timings: %s", json.dumps(self.report()))


#: Process-global default timer (the campaign records its stages here).
GLOBAL_TIMER = Timer()
