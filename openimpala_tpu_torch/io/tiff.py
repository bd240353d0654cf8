"""TIFF stack / sequence reader (the port's own copy of
``openimpala_tpu/io/tiff.py``; PIL is imported only for compressed files).

Re-design of ``OpenImpala::TiffReader`` (``src/io/TiffReader.{H,cpp}``):

* multi-directory (multi-page) stacks AND numbered file sequences with the
  ``base + %0Nd + suffix`` pattern (``TiffReader.cpp:85-89``);
* metadata-first: the constructor reads width/height/bits-per-sample/sample
  format/pages; voxels are only decoded by ``threshold``/``read``
  (``TiffReader.cpp:139-195``);
* 1-bit packed, 8/16/32/64-bit integer and float samples, tiled or striped
  layouts, FillOrder handling (``TiffReader.cpp:354-437``): uncompressed
  files decode through the numpy IFD codec (io/tiff_raw.py — vectorised
  strip/tile reads, the libtiff-equivalent coverage incl. float64 and tiled
  layouts PIL cannot represent); compressed files fall back to PIL's codec;
* chunked decode: ``read(z0, z1)`` returns a z-slab so distributed ingest
  never materialises the full volume on one host.

Axis convention: TIFF page rows are Y, columns are X, pages are Z; the
volume is returned as (X, Y, Z) like the reference's AMReX box
(``TiffReader.H:117-123``).
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np


class TiffReader:
    slab_axis = 2  # chunked reads stream Z pages (io/ingest.py protocol)

    def __init__(self, filename: str):
        self._files = None  # list of files for sequence mode
        self._filename = filename
        self._is_read = False
        self.width = self.height = self.depth = 0
        self.bits_per_sample = 0
        self.sample_format = "uint"
        self._read_metadata()

    # -- metadata ---------------------------------------------------------
    def _sequence_files(self):
        """Detect a numbered sequence (reference sequence support,
        ``TiffReader.cpp:85-138``): either an explicit ``base%0Nd.suffix``
        printf-style template, or — when the named file does not exist — a
        ``base<digits>suffix`` sibling glob."""
        m = re.match(r"^(.*?)%0?(\d+)d(.*)$", self._filename)
        if m:
            base, ndigits, suffix = m.groups()
            pattern = f"{base}{'[0-9]' * int(ndigits)}{suffix}"
            files = sorted(glob.glob(pattern))
            if not files:
                raise FileNotFoundError(
                    f"TiffReader: no files match sequence pattern {pattern}"
                )
            return files
        if os.path.exists(self._filename):
            return None
        m = re.match(r"^(.*?)(\d+)(\.[^.]+)$", self._filename)
        if not m:
            return None
        base, digits, suffix = m.groups()
        pattern = f"{base}{'[0-9]' * len(digits)}{suffix}"
        files = sorted(glob.glob(pattern))
        return files or None

    def _read_metadata(self):
        self._files = self._sequence_files()
        first = self._files[0] if self._files else self._filename
        self._raw = None  # numpy IFD codec handle (uncompressed files)
        try:
            from .tiff_raw import RawTiff

            rt = RawTiff(first)
            m = rt.meta(0)
            if m["compression"] == 1:
                self._raw = rt
                self.width, self.height = m["width"], m["height"]
                self.bits_per_sample = m["bps"]
                self.sample_format = m["format"]
                spp = m["spp"]
                self.depth = (len(self._files) if self._files
                              else len(rt.pages))
            else:
                raise ValueError("compressed; use PIL")
        except ValueError:
            from PIL import Image

            with Image.open(first) as im:
                self.width, self.height = im.size
                tags = getattr(im, "tag_v2", {})
                self.bits_per_sample = int(
                    tags.get(258, (1 if im.mode == "1" else 8))
                    if not isinstance(tags.get(258), tuple)
                    else tags.get(258)[0])
                fmt = tags.get(339, 1)
                if isinstance(fmt, tuple):
                    fmt = fmt[0]
                self.sample_format = {1: "uint", 2: "int",
                                      3: "float"}.get(int(fmt), "uint")
                spp = tags.get(277, 1)
                if isinstance(spp, tuple):
                    spp = spp[0]
                spp = int(spp)
                if self._files:
                    self.depth = len(self._files)
                else:
                    self.depth = getattr(im, "n_frames", 1)
        if spp != 1:
            raise ValueError(
                f"TiffReader: only 1 sample per pixel supported (got {spp}), "
                "matching the reference (TiffReader.cpp:167-173)"
            )
        if self.bits_per_sample not in (1, 8, 16, 32, 64):
            raise ValueError(
                f"TiffReader: unsupported bits-per-sample {self.bits_per_sample}"
            )
        self._is_read = True

    # -- reference-contract accessors ------------------------------------
    def is_read(self) -> bool:
        return self._is_read

    def box(self):
        """((0,0,0), (W-1, H-1, D-1)) index box like ``TiffReader::box``."""
        return (0, 0, 0), (self.width - 1, self.height - 1, self.depth - 1)

    @property
    def shape(self):
        return (self.width, self.height, self.depth)

    # -- voxel decode -----------------------------------------------------
    def _page(self, z: int) -> np.ndarray:
        if self._raw is not None:
            if self._files:
                from .tiff_raw import RawTiff

                # sequence mode: one single-page file per z
                return RawTiff(self._files[z]).read_page(0)
            return self._raw.read_page(z)
        from PIL import Image

        if self._files:
            with Image.open(self._files[z]) as im:
                return np.asarray(im)
        with Image.open(self._filename) as im:
            im.seek(z)
            return np.asarray(im)

    def read(self, z0: int = 0, z1: int | None = None) -> np.ndarray:
        """Decode pages [z0, z1) into an (X, Y, z1-z0) float-interpretable
        array (native dtype preserved; 1-bit pages become bool)."""
        z1 = self.depth if z1 is None else z1
        pages = [self._page(z) for z in range(z0, z1)]
        vol_zyx = np.stack(pages)  # (Z, Y, X)
        return np.ascontiguousarray(vol_zyx.transpose(2, 1, 0))

    def threshold(self, thr: float, vtrue: int = 1, vfalse: int = 0,
                  chunk_z: int = 64) -> np.ndarray:
        """(X, Y, Z) int8 volume, ``value > thr ? vtrue : vfalse`` — the
        strict-greater semantics of the reference ``threshold``
        (``TiffReader.H:141-180``)."""
        out = np.empty(self.shape, np.int8)
        for z0 in range(0, self.depth, chunk_z):
            z1 = min(self.depth, z0 + chunk_z)
            vals = self.read(z0, z1).astype(np.float64)
            out[:, :, z0:z1] = np.where(vals > thr, vtrue, vfalse).astype(np.int8)
        return out
