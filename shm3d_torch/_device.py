"""Device and dtype policy of the PyTorch port.

Every entry point takes an explicit ``device``; nothing here falls back to
the CPU when a GPU was asked for.  On CUDA, float32 matrix products and
convolutions run in full float32: TF32 keeps about three decimal digits,
which the whitening projector (cond ~1e6) and the Krylov recurrences cannot
absorb.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:0", "cpu", ...).

    Raises when CUDA is asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype named by ``SignedHeatOptions.dtype``."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype={name!r}; expected one of {sorted(_DTYPES)}") from None


def synchronize(device: torch.device) -> None:
    """Wait for the queued work of ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak_memory(device: torch.device) -> None:
    """Start ``torch.cuda.max_memory_allocated`` anew on ``device`` (no-op on
    the CPU).  CUDA is initialised first: in a process that has not used
    the card yet the allocator's statistics do not exist, and the reset
    raises "Invalid device argument"."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
