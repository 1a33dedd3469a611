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


# The dry run's devices (``launch.dryrun``): under its
# ``FakeTensorMode`` a fake tensor keeps its device's index, so a 16 x 16
# or 2 x 16 x 16 mesh of them books each op on its device, and no memory
# is allocated.  They stand for ``cuda:i`` and run the card's branches
# (the port's branches test for the CPU).  Fake tensors on ``cuda:i`` are
# not used: autograd asks a CUDA device guard for each one, which a build
# without CUDA lacks (the process aborts).  A device index is a signed
# byte, so a type holds 256 fake devices (index ``i`` reads back as ``i -
# 256`` from 128 and as None at 255): devices 0-255 are ``meta``, 256-511
# ``lazy``, the two types whose fake tensors take autograd here.
FAKE_DEVICE_TYPES = ("meta", "lazy")


def fake_device(index: int) -> torch.device:
    """The dry run's fake device ``index`` (0-511)."""
    return torch.device(FAKE_DEVICE_TYPES[index // 256], index % 256)


def fake_index(device: torch.device) -> int:
    """The index ``fake_device`` was given for ``device``."""
    j = 255 if device.index is None else device.index % 256
    return 256 * FAKE_DEVICE_TYPES.index(device.type) + j
