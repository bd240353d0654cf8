"""HDF5 volume reader (the port's own copy of ``openimpala_tpu/io/hdf5.py``;
h5py is imported inside the functions that need it).

Re-design of ``OpenImpala::HDF5Reader`` (``src/io/HDF5Reader.{H,cpp}``):

* a 3-D dataset at a given path; file dims are C-order (Z, Y, X) and are
  mapped to the (X, Y, Z) AMReX convention (``HDF5Reader.cpp:133-153``);
* hyperslab (partial) reads per z- or x-slab for distributed ingest
  (``HDF5Reader.cpp:287-306``);
* supported dtypes: {u,i}{8,16,32}, float32, float64
  (``HDF5Reader.cpp:359-392``);
* string/numeric attribute access (``HDF5Reader.cpp:205-248``).

Distributed-ingest IO strategy (``slab_axis``/``read_slab``): selecting an
X range of a C-order (Z, Y, X) dataset is a maximally strided read — for a
contiguous file every row is touched, and for a z-plane-chunked file every
chunk is decompressed, so per-device reads would multiply total IO by the
device count.  The reader therefore inspects the dataset's chunk layout
(``ds.chunks``) and advertises the axis whose hyperslabs map to contiguous
file extents: X (axis 0) only when the chunk X-extent is a small fraction
of the width (then an X hyperslab touches only overlapping chunks, as the
reference's per-box hyperslabs do, ``HDF5Reader.cpp:287-306``); otherwise Z
(axis 2, the file's slowest axis — contiguous slabs, streamed and scattered
exactly like TIFF pages).  Per-host IO then ≈ file size, independent of
device count; per-host peak memory during ingest is bounded by the per-
device X buffers (the int8 phase: 8 GiB for the 2048^3 weak-scaling volume
split over ≥2 hosts → 4 GiB/host) plus one ``slab_chunk`` read slab.
"""

from __future__ import annotations

import numpy as np


class HDF5Reader:
    def __init__(self, filename: str, dataset: str = "image"):
        import h5py

        self._filename = filename
        self._dataset = dataset
        self._is_read = False
        with h5py.File(filename, "r") as f:
            if dataset not in f:
                raise KeyError(f"HDF5Reader: dataset '{dataset}' not in {filename}")
            ds = f[dataset]
            if ds.ndim != 3:
                raise ValueError(f"HDF5Reader: dataset must be 3-D (got {ds.ndim}-D)")
            zz, yy, xx = ds.shape  # file is C-order (Z, Y, X)
            self.width, self.height, self.depth = int(xx), int(yy), int(zz)
            self.dtype = ds.dtype
            self.chunks = ds.chunks  # file order (z, y, x) or None
        allowed = {"uint8", "int8", "uint16", "int16", "uint32", "int32",
                   "float32", "float64"}
        if self.dtype.name not in allowed:
            raise ValueError(f"HDF5Reader: unsupported dtype {self.dtype}")
        # ingest protocol: prefer X hyperslabs only when chunks tile X
        # finely enough that an X-range read touches ~proportional IO
        if self.chunks is not None and self.chunks[2] <= max(1, self.width // 4):
            self.slab_axis = 0
            self.slab_chunk = self.chunks[2]
        else:
            self.slab_axis = 2  # contiguous/z-chunked: stream Z slabs
            self.slab_chunk = self.chunks[0] if self.chunks is not None else 64
        self._is_read = True

    def is_read(self) -> bool:
        return self._is_read

    def box(self):
        return (0, 0, 0), (self.width - 1, self.height - 1, self.depth - 1)

    @property
    def shape(self):
        return (self.width, self.height, self.depth)

    def attribute(self, name: str, dataset: str | None = None):
        """Read an attribute from the dataset (or root group)."""
        import h5py

        with h5py.File(self._filename, "r") as f:
            obj = f[dataset or self._dataset] if (dataset or self._dataset) else f
            val = obj.attrs[name]
        if isinstance(val, bytes):
            return val.decode()
        return val

    def read(self, x0: int = 0, x1: int | None = None) -> np.ndarray:
        """Hyperslab read of the x-slab [x0, x1) -> (x1-x0, Y, Z) array.

        The file stores (Z, Y, X); we select the X range in the last file
        axis (the reversed-dims hyperslab of ``HDF5Reader.cpp:287-306``).
        NOTE: on contiguous or z-plane-chunked files this is a strided read
        touching the whole dataset — bulk consumers go through
        ``read_slab`` (the ingest protocol), which picks the IO-efficient
        axis."""
        import h5py

        x1 = self.width if x1 is None else x1
        with h5py.File(self._filename, "r") as f:
            slab_zyx = f[self._dataset][:, :, x0:x1]
        return np.ascontiguousarray(np.asarray(slab_zyx).transpose(2, 1, 0))

    def read_z(self, z0: int = 0, z1: int | None = None) -> np.ndarray:
        """Hyperslab read of the z-slab [z0, z1) -> (X, Y, z1-z0) array —
        a CONTIGUOUS extent of the C-order file (and whole chunks when
        ``z0``/``z1`` align to the chunk Z-extent, ``slab_chunk``)."""
        import h5py

        z1 = self.depth if z1 is None else z1
        with h5py.File(self._filename, "r") as f:
            slab_zyx = f[self._dataset][z0:z1, :, :]
        return np.ascontiguousarray(np.asarray(slab_zyx).transpose(2, 1, 0))

    def read_slab(self, lo: int, hi: int) -> np.ndarray:
        """Ingest protocol: read [lo, hi) along ``slab_axis``."""
        return self.read(lo, hi) if self.slab_axis == 0 else self.read_z(lo, hi)

    def threshold(self, thr: float, vtrue: int = 1, vfalse: int = 0,
                  chunk: int = 128) -> np.ndarray:
        out = np.empty(self.shape, np.int8)
        n = self.width if self.slab_axis == 0 else self.depth
        step = max(chunk, self.slab_chunk)
        step -= step % self.slab_chunk  # chunk-aligned read boundaries
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            vals = self.read_slab(lo, hi).astype(np.float64)
            part = np.where(vals > thr, vtrue, vfalse).astype(np.int8)
            if self.slab_axis == 0:
                out[lo:hi] = part
            else:
                out[:, :, lo:hi] = part
        return out
