"""Device selection shared by the port's entry points: they run on the card
unless the caller asks for the CPU, and asking for CUDA without a card
raises instead of falling back."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for and absent.
    A CUDA device comes back with its index (``cuda`` is the current card,
    ``cuda:0`` by default), as a tensor made there reports it, so that it
    compares equal to its tensors' devices and keys the same dict entry."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
