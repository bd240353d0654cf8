"""Several processes, one program (counterpart of
``openimpala_tpu/parallel/multihost.py``).

The reference scales by launching one binary on N MPI ranks
(``mpirun Diffusion inputs``, any rank count, ``Diffusion.cpp:174``).  The
port does the same with ``torch.distributed``: every process runs this
same program on its own X slab (``parallel/mesh.py``), one process per
card under ``nccl``, or several on one card (or on the CPU) under
``gloo``.  A run across hosts is the same program: nothing below knows
where the other ranks are, so there is no second mechanism.

* **Start-up**: ``initialize`` joins the process group; ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
  or an explicit ``init_method`` (``tcp://host:port``,
  ``file:///shared/path``) and rank tell it where the others are.  The
  CLI joins through ``initialize_from_env``, which picks the backend.
* **Ingest**: each rank reads and thresholds only its own X slab
  (``io.ingest.threshold_sharded``, ``local_x_ranges``).
* **Results**: the drivers return the same scalars on every rank (sums
  over ranks are exact in rank order); only ``is_coordinator()`` should
  write result files.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, slab_range


def initialize(backend: str, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = 600.0) -> None:
    """Join this process to the run's process group (idempotent: a second
    call is a no-op).  ``backend``: ``"nccl"`` where every rank owns a
    card, ``"gloo"`` otherwise (several ranks on one card, or the CPU);
    the caller chooses.  ``init_method`` None means ``env://``
    (``torchrun``'s environment), and then ``world_size`` and ``rank``
    come from it too."""
    if dist.is_initialized():
        return
    kwargs = {"backend": backend,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    dist.init_process_group(**kwargs)


def initialize_from_env(device) -> bool:
    """Join the process group that ``torchrun`` (``python -m
    torch.distributed.run``) describes in the environment, for the CLI.
    The backend is a rule, not a setting: ``nccl`` where ``device`` is
    CUDA and every local rank has a card of its own (``LOCAL_WORLD_SIZE``
    at most the cards), ``gloo`` otherwise (several ranks on one card, or
    the CPU).  Returns True where this call made the group (the caller
    then ends it), False where a group already existed or the
    environment names one rank or none."""
    if dist.is_initialized():
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    local = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ["WORLD_SIZE"]))
    own_card = (torch.device(device).type == "cuda"
                and torch.cuda.is_available()
                and local <= torch.cuda.device_count())
    initialize("nccl" if own_card else "gloo")
    return True


def is_coordinator() -> bool:
    """True on the process that should write result files (rank 0, or a
    process with no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(device=None) -> Mesh:
    """The mesh over every rank of the default group (``make_mesh``)."""
    return make_mesh(device=device)


def local_x_ranges(mesh: Mesh, X: int) -> list:
    """The ``[x0, x1)`` planes of the original X extent that this rank's
    slab of the padded X axis holds (empty where the slab is all
    padding): what a per-rank reader reads."""
    x0, x1 = slab_range(mesh, X)
    return [(x0, min(x1, X))] if x0 < X else []
