"""The card the run uses: its name and power limit as ``nvidia-smi`` reads
them, and the peaks the rooflines are held to (NVIDIA's H100 SXM data
sheet; the SM clock is the card's own ``clocks.max.sm``)."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict

SMS = 132                 # streaming multiprocessors of an H100 SXM
MUFU_PER_CLK = 16         # MUFU (SFU) results an SM a clock
HBM_BYTES_S = 3.35e12     # HBM3 bandwidth of an H100 SXM


def smi() -> Dict[str, str]:
    """name, power.limit and clocks.max.sm of the first card (empty values
    where ``nvidia-smi`` is absent)."""
    keys = ("name", "power.limit", "clocks.max.sm")
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {k: "" for k in keys}
    out = subprocess.run([exe, f"--query-gpu={','.join(keys)}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    first = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    vals = [v.strip() for v in first.split(",")]
    return dict(zip(keys, vals + [""] * (len(keys) - len(vals))))


def sfu_results_per_s(max_sm_mhz: float) -> float:
    """MUFU results a second of the whole card at its maximum SM clock."""
    return SMS * MUFU_PER_CLK * max_sm_mhz * 1e6
