"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU on
their own: a CPU run is asked for explicitly (the tests pass
``device="cpu"``)."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is asked for and
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
