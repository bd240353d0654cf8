"""Direction helpers (reference ``Tortuosity.H:9-38`` Direction enum and the
string parsing in ``Diffusion.cpp:630-648``) and the device rule of the
port's entry points."""

from __future__ import annotations

import torch

DIRECTIONS = {"X": 0, "Y": 1, "Z": 2}
_NAMES = {v: k for k, v in DIRECTIONS.items()}


def parse_direction(d) -> int:
    """Accept 0/1/2 or 'X'/'Y'/'Z' (case-insensitive)."""
    if isinstance(d, str):
        return DIRECTIONS[d.strip().upper()]
    return int(d)


def direction_name(d: int) -> str:
    return _NAMES[int(d)]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means ``"cuda"``; a CUDA
    device on a machine without one raises — the entry points never fall
    back to the CPU quietly (pass ``device="cpu"`` to ask for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run on the CPU")
    return dev


def device_hbm_limit(device=None) -> int:
    """The memory of ``device`` in bytes (None means the current CUDA
    device): ``torch.cuda.mem_get_info``'s total on CUDA, 0 for the CPU and
    any device that reports none (counterpart of the JAX package's
    ``solve/fgmres.py::device_hbm_limit``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(dev)[1])
