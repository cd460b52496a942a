"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Return ``device`` as a ``torch.device``.

    The entry points default to ``"cuda"``.  Asking for CUDA on a machine
    without it raises: nothing moves to the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
