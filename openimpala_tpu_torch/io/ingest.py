"""Distributed ingest: each rank reads and thresholds only its own X slab
(counterpart of ``openimpala_tpu/io/ingest.py``; reference per-rank reads,
``TiffReader.cpp:289-444``, ``HDF5Reader.cpp:280-311``).  The volume never
exists whole on any rank (but for readers that can only read the whole
file).

Reader slab protocol (``slab_axis`` attribute; ``read_slab(lo, hi)`` where
the reader's public ``read`` is not the slab accessor, e.g. HDF5;
``slab_chunk`` optionally hints the IO-aligned read granularity):

* 0 - the reader reads X slabs directly (RAW memmap ranges, HDF5 files
  chunked finely along X): a rank reads exactly its planes;
* 2 - the reader streams Z slabs (TIFF pages, contiguous HDF5).  Under a
  mesh of several ranks the pages are partitioned: rank r decodes only
  ``[r*zloc, min((r+1)*zloc, Z))`` with ``zloc = ceil(Z / n)`` (the
  reference's per-rank strip reads), and one all-to-all
  (``Mesh.all_to_all``) turns the Z split into the X slabs
  (``_threshold_z_partitioned``, the JAX package's multi-process rule:
  here every rank is a process).  Alone, a rank decodes every Z chunk and
  keeps its X slab of it;
* None - whole-file readers (DAT, ``DatReader.cpp:122-145``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import slab_range

PAD_FILL = -1  # padding value outside the physical domain: not a phase id


def threshold_sharded(reader, thr: float, mesh, vtrue: int = 1,
                      vfalse: int = 0, chunk: int = 64,
                      z_partition: bool | None = None):
    """This rank's X slab of ``reader``'s volume thresholded (``value >
    thr`` gives ``vtrue``, else ``vfalse``) as an int8 tensor on the mesh's
    device.  X is padded to a multiple of the mesh size with ``PAD_FILL``
    cells, which are outside every phase and so inactive in every
    operator.  Returns ``(slab, original_shape)``: pass both to
    ``tortuosity(slab, ..., mesh=mesh, original_shape=original_shape)``.

    ``z_partition``: for a Z-streaming reader (``slab_axis == 2``), each
    rank decodes only its share of the pages and one all-to-all gives
    each its X slab (module docstring); None engages it where the mesh
    has more than one rank.  Every rank must call this then."""
    X, Y, Z = (int(v) for v in reader.shape)
    x0, x1 = slab_range(mesh, X)
    xloc = x1 - x0
    x1 = min(x1, X)
    slab_axis = getattr(reader, "slab_axis", None)
    read_slab = getattr(reader, "read_slab", reader.read)
    slab_chunk = getattr(reader, "slab_chunk", None)
    if slab_chunk:  # align read boundaries to the reader's IO granularity
        chunk = -(-max(chunk, slab_chunk) // slab_chunk) * slab_chunk

    def _threshold(vals):
        return np.where(vals.astype(np.float64) > thr, vtrue,
                        vfalse).astype(np.int8)

    device = mesh.device if mesh is not None else "cpu"
    if slab_axis == 2 and (z_partition if z_partition is not None
                           else mesh is not None and mesh.size > 1):
        slab = _threshold_z_partitioned(read_slab, _threshold, mesh,
                                        (X, Y, Z), xloc, chunk)
        return slab.to(device), (X, Y, Z)
    slab = np.full((xloc, Y, Z), PAD_FILL, np.int8)
    if x0 < X:
        if slab_axis == 0:  # hyperslab: exactly this rank's planes
            slab[:x1 - x0] = _threshold(read_slab(x0, x1))
        elif slab_axis == 2:  # Z stream: keep this rank's X range of each
            for z0 in range(0, Z, chunk):
                z1 = min(Z, z0 + chunk)
                slab[:x1 - x0, :, z0:z1] = _threshold(
                    read_slab(z0, z1))[x0:x1]
        else:
            slab[:x1 - x0] = _threshold(reader.read())[x0:x1]
    return torch.from_numpy(slab).to(device), (X, Y, Z)


def _threshold_z_partitioned(read_slab, threshold, mesh, shape, xloc: int,
                             chunk: int):
    """This rank's X slab from a Z-page split: the rank decodes its pages
    ``[r*zloc, min((r+1)*zloc, Z))`` in chunks into an (n*xloc, Y, zloc)
    buffer (X padded with ``PAD_FILL``, the Z padding of the last ranks
    too), one all-to-all sends block j of X to rank j, and the received Z
    blocks, in rank order, are this rank's slab with the Z padding
    cropped.  A host tensor (the all-to-all stays on the host under gloo
    and goes through the card under nccl)."""
    X, Y, Z = shape
    n = 1 if mesh is None else mesh.size
    r = 0 if mesh is None else mesh.rank
    zloc = -(-Z // n)
    z0, z1 = r * zloc, min((r + 1) * zloc, Z)
    buf = np.full((n * xloc, Y, zloc), PAD_FILL, np.int8)
    for c0 in range(z0, z1, chunk):
        c1 = min(z1, c0 + chunk)
        buf[:X, :, c0 - z0:c1 - z0] = threshold(read_slab(c0, c1))
    send = torch.from_numpy(buf)
    recv = send if mesh is None else mesh.all_to_all(send)
    # block j holds rank j's pages of this rank's X slab
    slab = recv.reshape(n, xloc, Y, zloc).permute(1, 2, 0, 3)
    return slab.reshape(xloc, Y, n * zloc)[:, :, :Z].contiguous()
