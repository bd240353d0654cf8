"""Direction helpers (reference ``Tortuosity.H:9-38`` Direction enum and the
string parsing in ``Diffusion.cpp:630-648``) and the device rule of the
port's entry points."""

from __future__ import annotations

import contextlib
import fcntl
import os

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


def count_true(mask, mesh=None) -> int:
    """Number of nonzero entries of ``mask`` (int64: voxel counts pass
    int32 beyond about 1290^3); under a ``mesh`` the sum over every rank's
    slab."""
    n = torch.count_nonzero(torch.as_tensor(mask)).to(torch.int64)
    if mesh is not None:
        n = mesh.allsum(n)
    return int(n)


def any_true(mask, mesh=None) -> bool:
    """Whether ``mask`` has a nonzero entry on this rank's slab or, under a
    ``mesh``, on any rank's."""
    return count_true(mask, mesh) > 0


def device_hbm_limit(device=None) -> int:
    """The memory of ``device`` in bytes (None means the current CUDA
    device): ``torch.cuda.mem_get_info``'s total on CUDA, 0 for the CPU and
    any device that reports none (counterpart of the JAX package's
    ``solve/fgmres.py::device_hbm_limit``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.mem_get_info(dev)[1])


@contextlib.contextmanager
def build_lock(directory):
    """An exclusive lock on ``directory``'s ``.lock`` file for the block,
    so that several processes (the ranks of a sharded run) never build
    the same library at once: the first builds, the others wait and find
    it built."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
