"""The X-slab decomposition over ``torch.distributed`` (counterpart of
``openimpala_tpu/parallel/mesh.py``; reference ``BoxArray.maxSize`` +
``DistributionMapping``, ``src/props/Diffusion.cpp:266-268``).

The JAX package is single-controller: one program, partitioned by GSPMD.
The port is SPMD per process, as MPI is: every rank runs the same driver
on its own X slab of the volume, and ranks talk only where the solver
needs another rank's data (halo planes before a stencil, the sums of dot
products and counts, the plane exchanges of the percolation fill, the
flux faces, and the gathered coarse levels of the multigrid cycle).

A ``Mesh`` is the process group, its size, this rank and this rank's
device.  Its collectives take and return tensors on that device:

* ``nccl`` (one card per rank): the tensors go to the library as they are;
* ``gloo`` (several ranks on one card, or the CPU): gloo has no send and
  receive for CUDA tensors, so under gloo every CUDA tensor goes through a
  pinned host buffer on the way out and in.  That is the backend's
  requirement; ``make_mesh`` logs it once.

Sums over ranks (``allsum``) gather the partial values and add them in
rank order in float64, so every rank holds the same bits and takes the
same branch; maxima and minima (``allmax``, ``allmin``: the smoothed-
aggregation prune, FGMRES's restart depth) are exact.  ``stats`` counts
every exchange, gather, sum, maximum, minimum and all-to-all with its
bytes.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import socket
import zlib

import numpy as np
import torch
import torch.distributed as dist

AXIS = "x"  # name of the decomposed axis (the JAX package's mesh axis)

# Auto-sharding engages only above this volume size: tiny problems are
# faster on one rank and the unit-test volumes keep their single-rank
# results (the JAX package's rule).
AUTO_SHARD_MIN_CELLS = 96 ** 3

# since reset_stats(): halo exchanges and the bytes each rank sent for
# them, gathers and their bytes received, sums, maxima and minima over
# ranks (each one gather), all-to-alls and the bytes each rank sent to
# the others; ``coarse_slab_exchanges``: the halo exchanges made inside
# a coarsest-level solve on slabs (``solve/slab_mg.py``), counted in
# ``halo_exchanges`` too
stats: collections.Counter = collections.Counter()

_log = logging.getLogger(__name__)
_said = {"staged": False}  # the host staging logged once a process


def reset_stats():
    stats.clear()


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D decomposition along X."""

    group: object  # the torch.distributed process group (None: default)
    size: int
    rank: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """Whether collectives go through host buffers (gloo with a CUDA
        device)."""
        return self.backend != "nccl" and self.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: contiguous, on the host under
        gloo (pinned, for CUDA), bool as uint8."""
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if self.staged:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t.contiguous()

    def _in(self, t: torch.Tensor, dtype) -> torch.Tensor:
        """A received buffer back on this rank's device in ``dtype``."""
        if self.staged:
            t = t.to(self.device, non_blocking=True)
        return t.to(dtype) if t.dtype != dtype else t

    def _empty_like_wire(self, t: torch.Tensor) -> torch.Tensor:
        dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
        if self.staged:
            return torch.empty(t.shape, dtype=dtype, pin_memory=True)
        return torch.empty(t.shape, dtype=dtype, device=t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on every rank), stacked in
        rank order: ``(size, *t.shape)`` on this rank's device."""
        wire = self._out(t).reshape(-1)
        out = wire.new_empty(self.size * wire.numel())
        _all_gather_flat(out, wire, group=self.group)
        stats["gathers"] += 1
        stats["gather_bytes"] += out.numel() * out.element_size()
        return self._in(out, t.dtype).reshape((self.size,) + tuple(t.shape))

    def all_gather_x(self, t: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's X slab."""
        parts = self.all_gather(t)
        return parts.reshape((-1,) + tuple(t.shape[1:]))

    def allsum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the ranks, the same bits on every rank: the
        partial values are gathered and added in rank order in float64
        (integers in int64), then cast back to ``t``'s dtype.  (gloo's
        all-reduce leaves different bits on different ranks.)"""
        acc_dtype = (torch.float64 if t.dtype.is_floating_point
                     else torch.int64)
        parts = self.all_gather(t.detach().to(acc_dtype))
        stats["allsums"] += 1
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.to(t.dtype)

    def allmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum of ``t`` over the ranks (one gather, reduced
        on every rank: exact, so the same bits everywhere)."""
        stats["allmaxes"] += 1
        return self.all_gather(t).amax(dim=0)

    def allmin(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum of ``t`` over the ranks (as ``allmax``)."""
        stats["allmins"] += 1
        return self.all_gather(t).amin(dim=0)

    def exchange(self, first: torch.Tensor, last: torch.Tensor,
                 periodic: bool):
        """(ghost_lo, ghost_hi): the previous rank's ``last`` and the next
        rank's ``first``; at the ends of a clamped axis, zeros.  Rank i
        sends ``last`` to i+1 and ``first`` to i-1, posted together
        (``batch_isend_irecv``) in one order on every rank, so no pair of
        ranks can wait on each other."""
        n, i = self.size, self.rank
        has_prev = periodic or i > 0
        has_next = periodic or i < n - 1
        if n == 1:
            if periodic:
                return last.clone(), first.clone()
            return torch.zeros_like(first), torch.zeros_like(last)
        w_first, w_last = self._out(first), self._out(last)
        glo = self._empty_like_wire(first) if has_prev else None
        ghi = self._empty_like_wire(last) if has_next else None
        for req in dist.batch_isend_irecv(
                self._plane_ops(w_first, w_last, glo, ghi)):
            req.wait()
        stats["halo_exchanges"] += 1
        stats["halo_bytes"] += (int(has_next) + int(has_prev)) \
            * w_first.numel() * w_first.element_size()
        ghost_lo = (torch.zeros_like(first) if glo is None
                    else self._in(glo, first.dtype))
        ghost_hi = (torch.zeros_like(last) if ghi is None
                    else self._in(ghi, last.dtype))
        return ghost_lo, ghost_hi

    def _plane_ops(self, w_first, w_last, r_lo, r_hi):
        """The P2P ops of one plane exchange, in one order on every rank:
        ``w_last`` to the next rank, which receives it as its lower ghost
        (tag 0), and ``w_first`` to the previous rank, its upper ghost (tag
        1); ``r_lo``/``r_hi`` None where there is no neighbour."""
        n, i, ops = self.size, self.rank, []
        if r_hi is not None:
            ops.append(dist.P2POp(dist.isend, w_last, (i + 1) % n,
                                  self.group, 0))
        if r_lo is not None:
            ops += [dist.P2POp(dist.irecv, r_lo, (i - 1) % n, self.group, 0),
                    dist.P2POp(dist.isend, w_first, (i - 1) % n, self.group,
                               1)]
        if r_hi is not None:
            ops.append(dist.P2POp(dist.irecv, r_hi, (i + 1) % n,
                                  self.group, 1))
        return ops

    def ghost_exchange(self, xp: torch.Tensor, periodic: bool,
                       count: str | None = None):
        """``exchange`` prepared once for a float slab padded by one X
        plane: the returned function writes the ghost planes ``xp[0]``
        and ``xp[-1]`` in place from the previous rank's last and the next
        rank's first interior plane (zeros at the ends of a clamped axis),
        posting the same P2P ops, built here, at every call.  Under
        ``nccl`` and on the CPU the planes go and come as views of ``xp``
        (an X plane is contiguous); staged, through pinned buffers made
        here.  Each call counts as a halo exchange, and in ``stats[count]``
        too where ``count`` is given.  The mesh has more than one rank."""
        n, i = self.size, self.rank
        has_prev = periodic or i > 0
        has_next = periodic or i < n - 1
        first, last, glo, ghi = xp[1], xp[-2], xp[0], xp[-1]
        wire = [first, last, glo, ghi]
        if self.staged:
            wire = [torch.empty(first.shape, dtype=xp.dtype, pin_memory=True)
                    for _ in wire]
        w_first, w_last, r_lo, r_hi = wire
        ops = self._plane_ops(w_first, w_last, r_lo if has_prev else None,
                              r_hi if has_next else None)
        nbytes = (int(has_next) + int(has_prev)) * first.numel() \
            * first.element_size()

        def run():
            if self.staged:
                w_first.copy_(first)
                w_last.copy_(last)
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for ghost, got, has in ((glo, r_lo, has_prev),
                                    (ghi, r_hi, has_next)):
                if not has:
                    ghost.zero_()
                elif self.staged:
                    ghost.copy_(got)
            stats["halo_exchanges"] += 1
            stats["halo_bytes"] += nbytes
            if count:
                stats[count] += 1
            return xp

        return run

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` holds ``size`` equal blocks along dim 0, block j for rank
        j; returns the blocks that the ranks sent this one, in rank order
        (one ``all_to_all_single``), on ``t``'s device.  Under gloo a CUDA
        tensor goes through pinned host buffers and a host tensor stays on
        the host; under nccl a host tensor goes through this rank's card."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: {t.shape[0]} rows do not split "
                             f"into {self.size} equal blocks")
        home = t.device
        if self.backend == "nccl":
            t = t.to(self.device)
        wire = self._out(t) if t.device.type == "cuda" else (
            t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous())
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        stats["all_to_alls"] += 1
        stats["all_to_all_bytes"] += (wire.numel() * wire.element_size()
                                      * (self.size - 1) // self.size)
        return out.to(home).to(t.dtype)

    def ranks_on_device(self) -> int:
        """How many ranks of the mesh, this one included, run on this
        rank's device (the same card of the same host, or the same host's
        CPU): they share its memory.  One gather."""
        host = zlib.crc32(socket.gethostname().encode())
        index = self.device.index if self.device.type == "cuda" else -1
        mine = torch.tensor([host, index], dtype=torch.int64)
        parts = self.all_gather(mine.to(self.device)).cpu()
        return int((parts == mine).all(dim=1).sum())

    def barrier(self):
        dist.barrier(group=self.group)


# the flat all-gather: ``all_gather_single`` where torch has it (it
# deprecates ``all_gather_into_tensor``), else the older name
_all_gather_flat = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(group=None, device=None) -> Mesh:
    """This rank's ``Mesh`` over ``group`` (None: the default group, which
    ``parallel.multihost.initialize`` sets up).  ``device`` defaults to
    ``cuda:(local_rank % device_count)``; a CUDA device without an index
    takes that index too; ``device="cpu"`` is for runs without a card.
    A CUDA device becomes the current device of this process."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize (or torch.distributed."
                           "init_process_group) first")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this machine; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda",
                               _local_rank(rank) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    mesh = Mesh(group=group, size=size, rank=rank, device=dev,
                backend=backend)
    if mesh.staged and not _said["staged"]:
        _said["staged"] = True
        _log.info("rank %d: backend %s has no send/receive for CUDA tensors;"
                  " halo planes and sums go through pinned host buffers",
                  rank, backend)
    return mesh


def resolve_mesh(mesh, shape, min_cells: int | None = None,
                 device=None) -> Mesh | None:
    """A driver's ``mesh`` argument: None (one rank), a ``Mesh`` (used as
    given; one of size 1 is None), or ``"auto"``: this process group's
    mesh when one is initialised with more than one rank and the volume
    has at least ``min_cells`` cells (None: ``AUTO_SHARD_MIN_CELLS`` as it
    is at the call), else None.  ``device``: the mesh's
    device under "auto" (``make_mesh``'s rule when None)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return mesh if mesh.size > 1 else None
    if mesh == "auto":
        if not dist.is_available() or not dist.is_initialized():
            return None
        if dist.get_world_size() <= 1:
            return None
        if int(np.prod(shape)) < (AUTO_SHARD_MIN_CELLS if min_cells is None
                                  else min_cells):
            return None
        return make_mesh(device=device)
    raise ValueError(f"mesh must be None, 'auto', or a Mesh; got {mesh!r}")


def fingerprint(a) -> int:
    """CRC-32 of an array's bytes (numpy, or a tensor read back from its
    device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(a))


def require_same(mesh: Mesh, values, what: str):
    """Raise ``ValueError`` on every rank unless every rank of ``mesh``
    passed the same ``values`` (integers): one gather, the check that an
    SPMD call got the same input on every rank.  (A call that only some
    ranks make waits here for the others, up to the group's timeout.)"""
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64)
    parts = mesh.all_gather(mine.to(mesh.device)).cpu()
    other = [r for r in range(mesh.size) if not torch.equal(parts[r],
                                                            parts[0])]
    if other:
        raise ValueError(
            f"{what} under a mesh of {mesh.size} ranks: rank(s) {other} "
            f"passed other inputs than rank 0 ({parts[other[0]].tolist()} "
            f"against {parts[0].tolist()}); every rank must call it with "
            "the same volume and arguments (pass mesh=None for a call of "
            "one rank on its own volume)")


def slab_range(mesh: Mesh | None, X: int) -> tuple:
    """``(x0, x1)``: this rank's planes of an X extent padded to the mesh
    (``X`` rounded up to a multiple of its size)."""
    if mesh is None:
        return 0, X
    xloc = -(-X // mesh.size)
    return mesh.rank * xloc, (mesh.rank + 1) * xloc


def shard_volume(x, mesh: Mesh | None):
    """This rank's X slab of the global (X, Y, Z) volume ``x`` (a tensor or
    a numpy array; a copy).  X must be divisible by the mesh size: pad the
    volume with inactive cells first (``ops.masks.pad_volume_to``)."""
    if mesh is None:
        return x
    n = mesh.size
    if x.shape[0] % n != 0:
        raise ValueError(
            f"volume X extent {x.shape[0]} not divisible by mesh size {n}; "
            "pad with inactive cells first (ops.masks.pad_volume_to)")
    x0, x1 = slab_range(mesh, x.shape[0])
    slab = x[x0:x1]
    if isinstance(slab, torch.Tensor):
        return slab.contiguous().clone()
    return np.ascontiguousarray(slab).copy()
