"""Explicit device selection: ``cuda`` unless the caller asks for ``cpu``.

There is no silent fallback.  Asking for ``cuda`` on a machine without a card
raises, so a run that was meant for the card never carries on on the CPU.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device`` ('cuda' or 'cpu'); raises when 'cuda'
    is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "card; pass device='cpu' (--device cpu) to run "
                           "the plain versions on the CPU")
    return dev
