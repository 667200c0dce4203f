"""Per-phase wall-clock timing and a profiler trace (port of
shm3d.utils.timing's PhaseTimer and profiler_trace).

Each phase ends with a device synchronize, so a span covers the device work
queued inside it and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .._device import synchronize


class PhaseTimer:
    def __init__(self, device: torch.device, verbose: bool = False):
        self.device = device
        self.verbose = verbose
        self.spans: List[Tuple[str, float]] = []
        self.notes: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.spans.append((name, dt))
            if self.verbose:
                print(f"[shm3d_torch] {name}: {dt:.4f} s", file=sys.stderr)

    def note(self, msg: str):
        self.notes.append(msg)
        if self.verbose:
            print(f"[shm3d_torch]   {msg}", file=sys.stderr)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Trace the region with ``torch.profiler`` (host and, where a card is
    visible, CUDA activity) when ``logdir`` is set, and write it there as a
    Chrome trace (``trace.json``; chrome://tracing or Perfetto)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
