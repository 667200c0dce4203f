"""Per-phase wall-clock timing (port of shm3d.utils.timing.PhaseTimer).

Each phase ends with a device synchronize, so a span covers the device work
queued inside it and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Tuple

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
