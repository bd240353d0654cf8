"""Headerless RAW volume reader (the port's own copy of
``openimpala_tpu/io/raw.py``).

Re-design of ``OpenImpala::RawReader`` (``src/io/RawReader.{H,cpp}``): the
caller supplies dims + a ``RawDataType`` covering {U,I}{8,16,32}, F32, F64 x
LE/BE (``RawReader.H:30-46``).  Data is in XYZ order, k slowest
(``RawReader.H:55-57``).  Reads use numpy memmap so only the voxels a shard
needs are ever touched.
"""

from __future__ import annotations

import enum

import numpy as np


class RawDataType(enum.Enum):
    """Mirrors the reference enum (``RawReader.H:30-46``)."""

    UINT8 = "|u1"
    INT8 = "|i1"
    INT16_LE = "<i2"
    INT16_BE = ">i2"
    UINT16_LE = "<u2"
    UINT16_BE = ">u2"
    INT32_LE = "<i4"
    INT32_BE = ">i4"
    UINT32_LE = "<u4"
    UINT32_BE = ">u4"
    FLOAT32_LE = "<f4"
    FLOAT32_BE = ">f4"
    FLOAT64_LE = "<f8"
    FLOAT64_BE = ">f8"

    @classmethod
    def parse(cls, s):
        if isinstance(s, cls):
            return s
        return cls[s.strip().upper()]


class RawReader:
    slab_axis = 0  # io/ingest.py slab protocol
    def __init__(self, filename: str, width: int, height: int, depth: int,
                 datatype):
        self._filename = filename
        self.width, self.height, self.depth = int(width), int(height), int(depth)
        self.datatype = RawDataType.parse(datatype)
        self.dtype = np.dtype(self.datatype.value)
        n = self.width * self.height * self.depth
        expected = n * self.dtype.itemsize
        import os

        actual = os.path.getsize(filename)
        if actual < expected:
            raise ValueError(
                f"RawReader: file {filename} has {actual} bytes, expected "
                f">= {expected} for {width}x{height}x{depth} {self.datatype.name}"
            )
        self._is_read = True

    def is_read(self) -> bool:
        return self._is_read

    def box(self):
        return (0, 0, 0), (self.width - 1, self.height - 1, self.depth - 1)

    @property
    def shape(self):
        return (self.width, self.height, self.depth)

    def _mmap(self):
        n = self.width * self.height * self.depth
        return np.memmap(self._filename, dtype=self.dtype, mode="r", shape=(n,))

    def read(self, x0: int = 0, x1: int | None = None) -> np.ndarray:
        """(x1-x0, Y, Z) native-dtype slab (host-endian converted)."""
        x1 = self.width if x1 is None else x1
        mm = self._mmap().reshape(self.depth, self.height, self.width)  # (Z,Y,X)
        slab = np.asarray(mm[:, :, x0:x1])
        slab = slab.astype(slab.dtype.newbyteorder("="))
        return np.ascontiguousarray(slab.transpose(2, 1, 0))

    def get_value(self, i: int, j: int, k: int):
        idx = i + j * self.width + k * self.width * self.height
        return self._mmap()[idx]

    def threshold(self, thr: float, vtrue: int = 1, vfalse: int = 0,
                  chunk_x: int = 256) -> np.ndarray:
        out = np.empty(self.shape, np.int8)
        for x0 in range(0, self.width, chunk_x):
            x1 = min(self.width, x0 + chunk_x)
            vals = self.read(x0, x1).astype(np.float64)
            out[x0:x1] = np.where(vals > thr, vtrue, vfalse).astype(np.int8)
        return out
