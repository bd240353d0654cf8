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
* 2 - the reader streams Z slabs (TIFF pages, contiguous HDF5): a rank
  decodes every Z chunk and keeps its X slab of it (the JAX package's
  multi-process page split, ``_threshold_z_partitioned``, is not ported
  yet);
* None - whole-file readers (DAT, ``DatReader.cpp:122-145``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import slab_range

PAD_FILL = -1  # padding value outside the physical domain: not a phase id


def threshold_sharded(reader, thr: float, mesh, vtrue: int = 1,
                      vfalse: int = 0, chunk: int = 64):
    """This rank's X slab of ``reader``'s volume thresholded (``value >
    thr`` gives ``vtrue``, else ``vfalse``) as an int8 tensor on the mesh's
    device.  X is padded to a multiple of the mesh size with ``PAD_FILL``
    cells, which are outside every phase and so inactive in every
    operator.  Returns ``(slab, original_shape)``: pass both to
    ``tortuosity(slab, ..., mesh=mesh, original_shape=original_shape)``."""
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
    device = mesh.device if mesh is not None else "cpu"
    return torch.from_numpy(slab).to(device), (X, Y, Z)
