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
  never materialises the full volume on one host;
* ``threshold_tensor``: the same threshold on a device.  The pages' packed
  bytes go there as they lie in the file; the device unpacks the bits (or
  widens the samples), compares and turns the volume to (X, Y, Z).

Axis convention: TIFF page rows are Y, columns are X, pages are Z; the
volume is returned as (X, Y, Z) like the reference's AMReX box
(``TiffReader.H:117-123``).
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from ..utils import profiling
from .tiff_raw import ROWS_PER_STRIP, STRIP_CNT, STRIP_OFF, RawTiff

# (bits per sample, format) of the samples ``threshold_tensor`` takes: 1-bit
# of any format, as ``threshold`` (bit 1 is the value 1); the float format
# only in 32 bits, as the host codec
_DEVICE_SAMPLES = {(1, "uint"), (1, "int"), (1, "float"), (8, "uint"),
                   (8, "int"), (16, "uint"), (16, "int"), (32, "uint"),
                   (32, "int"), (32, "float")}
# bytes of the largest temporary of one step of the device's threshold (the
# float64 samples, or the unpacked bits)
_STEP_BYTES = 1 << 28


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

    def threshold_tensor(self, thr: float, vtrue: int = 1, vfalse: int = 0,
                         device="cpu") -> torch.Tensor | None:
        """``threshold(thr, vtrue, vfalse)`` on ``device``: the (X, Y, Z)
        int8 volume as a tensor there, equal to ``threshold``'s array; or
        None where the stack is not laid out as this path takes it, and
        ``threshold`` decodes it on the host.  It takes uncompressed,
        striped pages of one sample alike in layout: 1 bit (either
        FillOrder), 8 bit, and 16 or 32 bit little-endian (float in 32 bit
        only), in a multi-page file or a numbered sequence, classic TIFF or
        BigTIFF.

        Each file is opened once and its strips' bytes read as they lie
        into one (Z, Y, row bytes) host buffer (pinned for a card), which
        is copied to ``device`` once.  There, in steps of Z pages: 1-bit
        rows are unpacked in the FillOrder's bit order and their padding
        dropped, and bit b takes the value that ``b > thr`` gives in
        float64 (NaN and infinite thresholds included); wider samples are
        compared as float64, as on the host.  Each step is written turned
        to (X, Y, Z).  The pages go into ``profiling.counters
        ["device_pages"]``."""
        bps = self.bits_per_sample
        if self._raw is None or (bps, self.sample_format) not in \
                _DEVICE_SAMPLES:
            return None
        device = torch.device(device)
        W, H, D = self.shape
        row = (W * bps + 7) // 8
        first = self._raw.meta(0)
        host = torch.empty((D, H, row), dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        if not self._read_strips(memoryview(host.numpy().reshape(-1)), row,
                                 first):
            return None
        packed = host.to(device)
        # threshold's int8 values of vfalse and vtrue (np.where, astype)
        lut = torch.from_numpy(np.array([vfalse, vtrue]).astype(np.int8))
        lut = lut.to(device)
        if bps == 1:
            off, on = lut[int(0 > thr)], lut[int(1 > thr)]
            order = range(7, -1, -1) if first["fill_order"] == 1 \
                else range(8)
            masks = torch.tensor([1 << k for k in order], dtype=torch.uint8,
                                 device=device)
        else:
            off, on = lut[0], lut[1]
        out = torch.empty((W, H, D), dtype=torch.int8, device=device)
        step = max(1, _STEP_BYTES // (H * W * (1 if bps == 1 else 8)))
        for z0 in range(0, D, step):
            raw = packed[z0:z0 + step]
            if bps == 1:
                hit = (raw.unsqueeze(-1) & masks).ne(0).flatten(2)[..., :W]
            else:
                hit = _samples_f64(raw, bps, self.sample_format) > thr
            out[:, :, z0:z0 + step] = torch.where(hit, on, off).permute(
                2, 1, 0)
        profiling.counters["device_pages"] += D
        return out

    def _read_strips(self, dst: memoryview, row: int, first: dict) -> bool:
        """Every page's rows, ``row`` bytes each, from the files into
        ``dst`` in (Z, Y) order; False where a page is not laid out as
        ``threshold_tensor`` takes it (as ``first``, page 0's ``meta``, and
        ``_page_strips`` say) or a file ends early."""
        if self._files is None:
            runs = [_page_strips(self._raw, z, first, row)
                    for z in range(self.depth)]
            if None in runs:
                return False
            with open(self._raw.path, "rb") as f:
                return _read_runs(f, [r for page in runs for r in page], dst,
                                  0)
        page_bytes = self.height * row
        for z, path in enumerate(self._files):
            with open(path, "rb") as f:
                runs = _page_strips(RawTiff(path, f), 0, first, row)
                if runs is None or not _read_runs(f, runs, dst,
                                                  z * page_bytes):
                    return False
        return True


def _page_strips(rt, i: int, first: dict, row: int):
    """(file offset, bytes) of the rows of page ``i`` of ``rt``, strip by
    strip; None where the page is not laid out as ``first`` (page 0's
    ``meta``) says, or is compressed, tiled, of several samples, of
    multi-byte big-endian samples, or in strips that do not hold its
    rows."""
    m = rt.meta(i)
    if (any(m[k] != first[k] for k in ("width", "height", "bps", "format",
                                       "fill_order"))
            or m["compression"] != 1 or m["tiled"] or m["spp"] != 1
            or (m["bps"] > 8 and rt.bo != "<")):
        return None
    tags, height = rt.pages[i], m["height"]
    rows_per = tags.get(ROWS_PER_STRIP, [height])[0]
    offsets, counts = tags.get(STRIP_OFF, []), tags.get(STRIP_CNT, [])
    if (rows_per < 1 or len(offsets) != len(counts)
            or len(offsets) != -(-height // rows_per)):
        return None
    runs = [(o, min(rows_per, height - s * rows_per) * row)
            for s, o in enumerate(offsets)]
    if any(c < n for c, (_, n) in zip(counts, runs)):
        return None
    return runs


def _read_runs(f, runs, dst: memoryview, at: int) -> bool:
    """Read ``runs`` ((file offset, bytes), in the buffer's order) into
    ``dst`` from byte ``at`` on; runs that follow each other in the file
    are one read.  False where the file ends early."""
    merged = []
    for o, n in runs:
        if merged and merged[-1][0] + merged[-1][1] == o:
            merged[-1][1] += n
        else:
            merged.append([o, n])
    for o, n in merged:
        f.seek(o)
        if f.readinto(dst[at:at + n]) != n:
            return False
        at += n
    return True


def _samples_f64(raw: torch.Tensor, bps: int, fmt: str) -> torch.Tensor:
    """The little-endian samples of ``raw`` (uint8, rows of bytes last) as
    float64, the dtype of ``threshold``'s compare."""
    if bps == 8:
        vals = raw if fmt == "uint" else raw.view(torch.int8)
    elif fmt == "float":
        vals = raw.view(torch.float32)
    else:
        vals = raw.view(torch.int16 if bps == 16 else torch.int32)
        if fmt == "uint":  # two's complement back to the unsigned value
            vals = vals.to(torch.int64) & ((1 << bps) - 1)
    return vals.to(torch.float64)
