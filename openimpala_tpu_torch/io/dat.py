"""DAT binary volume reader (the port's own copy of
``openimpala_tpu/io/dat.py``).

Re-design of ``OpenImpala::DatReader`` (``src/io/DatReader.{H,cpp}``):
12-byte header of 3 little-endian int32 dims (W, H, D), then uint16 voxels
in XYZ order (i fastest, k slowest) — ``DatReader.cpp:90-145``.  Byte order
in the file is little-endian regardless of host (``DatReader.cpp:103-110``).
"""

from __future__ import annotations

import numpy as np


class DatReader:
    slab_axis = None  # io/ingest.py slab protocol
    DATA_DTYPE = np.dtype("<u2")  # fixed uint16 LE (DatReader.H:35)

    def __init__(self, filename: str):
        self._filename = filename
        self._is_read = False
        with open(filename, "rb") as f:
            header = f.read(12)
        if len(header) < 12:
            raise ValueError(f"DatReader: file too small for header: {filename}")
        w, h, d = np.frombuffer(header, dtype="<i4", count=3)
        if w <= 0 or h <= 0 or d <= 0:
            raise ValueError(f"DatReader: invalid dims in header: {w},{h},{d}")
        self.width, self.height, self.depth = int(w), int(h), int(d)
        self._is_read = True

    def is_read(self) -> bool:
        return self._is_read

    def box(self):
        return (0, 0, 0), (self.width - 1, self.height - 1, self.depth - 1)

    @property
    def shape(self):
        return (self.width, self.height, self.depth)

    def read(self) -> np.ndarray:
        """(X, Y, Z) uint16 volume (whole file, like the reference which
        loads the full volume per rank — ``DatReader.cpp:122-156``)."""
        n = self.width * self.height * self.depth
        raw = np.fromfile(self._filename, dtype=self.DATA_DTYPE, count=n, offset=12)
        if raw.size < n:
            raise ValueError(
                f"DatReader: file size mismatch, expected {n} voxels got {raw.size}"
            )
        # XYZ order, i fastest -> C-reshape as (Z, Y, X) then transpose
        return np.ascontiguousarray(
            raw.reshape(self.depth, self.height, self.width).transpose(2, 1, 0)
        )

    def get_raw_value(self, i: int, j: int, k: int) -> int:
        idx = i + j * self.width + k * self.width * self.height
        raw = np.fromfile(self._filename, dtype=self.DATA_DTYPE, count=1,
                          offset=12 + 2 * idx)
        return int(raw[0])

    def threshold(self, thr: float, vtrue: int = 1, vfalse: int = 0) -> np.ndarray:
        vals = self.read().astype(np.float64)
        return np.where(vals > thr, vtrue, vfalse).astype(np.int8)
