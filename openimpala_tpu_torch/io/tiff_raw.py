"""Minimal numpy TIFF codec for UNCOMPRESSED files — the coverage PIL lacks
(the port's own copy of ``openimpala_tpu/io/tiff_raw.py``; numpy only, so
it reads TIFFs where neither PIL nor tifffile is installed).

The reference decodes TIFFs with libtiff 4.6 and supports BPS ∈ {1,8,16,32,
64}, unsigned/signed/float samples, striped AND tiled layouts, both
FillOrder values, and BigTIFF transparently (``TiffReader.cpp:146-178,
354-437``; libtiff via ``containers/Singularity.deps.def:20-26``).  PIL
cannot represent 64-bit or float-64 samples, its tiled support is spotty,
and it cannot open BigTIFF at all, so this module parses the IFD chain
directly — classic (magic 42, 32-bit offsets) and BigTIFF (magic 43, 64-bit
offsets) — and decodes uncompressed strips/tiles with vectorised numpy (bit
unpacking via ``np.unpackbits`` with the FillOrder bit order).  Compressed
classic files fall back to PIL in io/tiff.py.

Also provides ``write_tiff`` (uncompressed, striped or tiled, any supported
dtype, classic or BigTIFF) — a STREAMING writer: each page's blocks go
straight to the file, so multi-GiB BigTIFF fixtures never materialise in
host memory.
"""

from __future__ import annotations

import struct

import numpy as np

# tag ids
W, H, BPS, COMP, SPP, FMT = 256, 257, 258, 259, 277, 339
STRIP_OFF, ROWS_PER_STRIP, STRIP_CNT = 273, 278, 279
TILE_W, TILE_L, TILE_OFF, TILE_CNT = 322, 323, 324, 325
FILL_ORDER = 266

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
# 16/17/18 = LONG8/SLONG8/IFD8 (BigTIFF)
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q", 17: "q", 18: "Q"}


class RawTiff:
    """IFD-chain parser (classic TIFF and BigTIFF); raises ValueError on
    anything it cannot decode (callers fall back to PIL)."""

    def __init__(self, path: str, f=None):
        """Parse ``path``'s IFD chain, through ``f`` where the caller has
        the file open already (binary, seekable)."""
        self.path = path
        if f is None:
            with open(path, "rb") as f:
                self._parse(f)
        else:
            self._parse(f)

    def _parse(self, f):
        f.seek(0)
        head = f.read(8)
        if head[:2] == b"II":
            self.bo = "<"
        elif head[:2] == b"MM":
            self.bo = ">"
        else:
            raise ValueError("not a TIFF")
        (magic,) = struct.unpack(self.bo + "H", head[2:4])
        if magic == 42:
            self.big = False
            (off,) = struct.unpack(self.bo + "I", head[4:8])
        elif magic == 43:
            # BigTIFF: u16 offset byte-size (always 8), u16 reserved 0,
            # u64 first-IFD offset (TIFF 6.0 BigTIFF spec; reference
            # reads these via libtiff 4.x)
            self.big = True
            offsize, zero = struct.unpack(self.bo + "HH", head[4:8])
            if offsize != 8 or zero != 0:
                raise ValueError("malformed BigTIFF header")
            (off,) = struct.unpack(self.bo + "Q", f.read(8))
        else:
            raise ValueError(f"not a TIFF (magic {magic})")
        self.pages = []
        while off:
            page, off = self._read_ifd(f, off)
            self.pages.append(page)

    def _read_ifd(self, f, off):
        f.seek(off)
        if self.big:
            (n,) = struct.unpack(self.bo + "Q", f.read(8))
            entry_sz, cnt_fmt, ptr_fmt, inline = 20, "Q", "Q", 8
        else:
            (n,) = struct.unpack(self.bo + "H", f.read(2))
            entry_sz, cnt_fmt, ptr_fmt, inline = 12, "I", "I", 4
        raw = f.read(n * entry_sz)
        (nxt,) = struct.unpack(self.bo + ptr_fmt,
                               f.read(struct.calcsize(ptr_fmt)))
        tags = {}
        for i in range(n):
            e = raw[i * entry_sz:(i + 1) * entry_sz]
            tag, typ = struct.unpack(self.bo + "HH", e[:4])
            (cnt,) = struct.unpack(self.bo + cnt_fmt,
                                   e[4:4 + struct.calcsize(cnt_fmt)])
            val = e[entry_sz - inline:]
            if typ not in _TYPE_FMT:
                continue  # skip rationals/ascii — not needed
            size = _TYPE_SIZE[typ] * cnt
            if size > inline:
                (ptr,) = struct.unpack(self.bo + ptr_fmt, val[:inline])
                f.seek(ptr)
                data = f.read(size)
            else:
                data = val[:size]
            tags[tag] = list(struct.unpack(self.bo + str(cnt) + _TYPE_FMT[typ],
                                           data))
        return tags, nxt

    # -- per-page metadata --------------------------------------------------
    def meta(self, i: int):
        t = self.pages[i]
        bps = t.get(BPS, [1])[0]
        fmt = {1: "uint", 2: "int", 3: "float"}.get(t.get(FMT, [1])[0], "uint")
        return {
            "width": t[W][0], "height": t[H][0], "bps": bps, "format": fmt,
            "spp": t.get(SPP, [1])[0],
            "compression": t.get(COMP, [1])[0],
            "fill_order": t.get(FILL_ORDER, [1])[0],
            "tiled": TILE_OFF in t,
        }

    def _dtype(self, bps, fmt):
        if bps == 1:
            return None  # packed bits
        kind = {"uint": "u", "int": "i", "float": "f"}[fmt]
        if fmt == "float" and bps not in (32, 64):
            raise ValueError(f"float{bps} samples unsupported")
        return np.dtype(f"{self.bo}{kind}{bps // 8}")

    def _unpack_rows(self, buf, n_rows, width, fill_order):
        """1-bit packed rows -> (n_rows, width) bool."""
        row_bytes = (width + 7) // 8
        arr = np.frombuffer(buf[: n_rows * row_bytes], np.uint8)
        arr = arr.reshape(n_rows, row_bytes)
        bits = np.unpackbits(arr, axis=1,
                             bitorder="big" if fill_order == 1 else "little")
        return bits[:, :width].astype(bool)

    def read_page(self, i: int) -> np.ndarray:
        """(H, W) array in the page's native dtype (bool for 1-bit)."""
        t = self.pages[i]
        m = self.meta(i)
        if m["compression"] != 1:
            raise ValueError("compressed TIFF — use the PIL path")
        if m["spp"] != 1:
            raise ValueError("only 1 sample per pixel supported "
                             "(TiffReader.cpp:167-173)")
        height, width, bps = m["height"], m["width"], m["bps"]
        dtype = self._dtype(bps, m["format"])
        with open(self.path, "rb") as f:
            if m["tiled"]:
                tw, tl = t[TILE_W][0], t[TILE_L][0]
                out = np.zeros((height, width),
                               dtype if dtype is not None else bool)
                tiles_across = -(-width // tw)
                for ti, off in enumerate(t[TILE_OFF]):
                    f.seek(off)
                    cnt = t[TILE_CNT][ti]
                    buf = f.read(cnt)
                    if bps == 1:
                        tile = self._unpack_rows(buf, tl, tw, m["fill_order"])
                    else:
                        tile = np.frombuffer(buf, dtype,
                                             count=tl * tw).reshape(tl, tw)
                    r0 = (ti // tiles_across) * tl
                    c0 = (ti % tiles_across) * tw
                    out[r0:r0 + tl, c0:c0 + tw] = tile[: height - r0, : width - c0]
                return out
            rows_per = t.get(ROWS_PER_STRIP, [height])[0]
            rows = []
            for si, off in enumerate(t[STRIP_OFF]):
                f.seek(off)
                buf = f.read(t[STRIP_CNT][si])
                n_rows = min(rows_per, height - si * rows_per)
                if bps == 1:
                    rows.append(self._unpack_rows(buf, n_rows, width,
                                                  m["fill_order"]))
                else:
                    rows.append(np.frombuffer(buf, dtype, count=n_rows * width)
                                .reshape(n_rows, width))
            return np.concatenate(rows, axis=0)


def _page_bytes(p, fill_order: int) -> int:
    """Packed byte size of one page (bool pages pack to 1 bit/pixel)."""
    if p.dtype == bool:
        return p.shape[0] * ((p.shape[1] + 7) // 8)
    return p.nbytes


def write_tiff(path: str, pages, tile: tuple[int, int] | None = None,
               fill_order: int = 1, big: bool | None = None):
    """Write uncompressed single-sample TIFF pages (striped, or tiled when
    ``tile=(tl, tw)``).  Supports bool (1-bit packed), {u,}int{8,16,32,64}
    and float{32,64} pages.

    ``big``: True → BigTIFF (magic 43, 64-bit offsets; required above the
    classic format's 4 GiB cap — the reference reads both transparently via
    libtiff 4.6); False → classic; None (default) → auto-select from the
    total packed size (sequences only).  ``pages`` may be a lazy iterable
    (e.g. a generator yielding memmap slices): pages stream straight to the
    file one at a time, so an 8 GiB fixture needs one page of memory, not
    eight GiB — pass ``big`` explicitly then, since auto-sizing needs the
    whole sequence up front.
    """
    if isinstance(pages, (list, tuple)):
        pages = [np.asarray(p) for p in pages]
        if big is None:
            total = sum(_page_bytes(p, fill_order) for p in pages)
            big = total > 2 ** 32 - (1 << 20)  # leave headroom for IFDs
    elif big is None:
        raise ValueError("write_tiff: pass big=True/False explicitly when "
                         "pages is a lazy iterable")

    with open(path, "wb") as f:
        if big:
            f.write(b"II+\x00\x08\x00\x00\x00" + struct.pack("<Q", 0))
            ifd_ptr_pos, ptr_fmt, inline = 8, "<Q", 8
            off_typ, cnt_hdr_fmt = 16, "<Q"  # LONG8 offsets, u64 entry count
            ehdr = "<HHQ"
        else:
            f.write(b"II*\x00" + struct.pack("<I", 0))
            ifd_ptr_pos, ptr_fmt, inline = 4, "<I", 4
            off_typ, cnt_hdr_fmt = 4, "<H"
            ehdr = "<HHI"

        for p in pages:
            p = np.asarray(p)
            height, width = p.shape
            if p.dtype == bool:
                bps, fmt = 1, 1
                packer = lambda a: np.packbits(
                    a, axis=1, bitorder="big" if fill_order == 1 else "little"
                ).tobytes()
            else:
                bps = p.dtype.itemsize * 8
                fmt = {"u": 1, "i": 2, "f": 3}[p.dtype.kind]
                packer = lambda a: a.astype(p.dtype.newbyteorder("<")).tobytes()

            # data blocks stream straight to the file
            offsets, counts = [], []
            if tile is None:
                data = packer(p)
                offsets.append(f.tell())
                counts.append(len(data))
                f.write(data)
            else:
                tl, tw = tile
                for r0 in range(0, height, tl):
                    for c0 in range(0, width, tw):
                        t_ = np.zeros((tl, tw), p.dtype)
                        sub = p[r0:r0 + tl, c0:c0 + tw]
                        t_[: sub.shape[0], : sub.shape[1]] = sub
                        data = packer(t_)
                        offsets.append(f.tell())
                        counts.append(len(data))
                        f.write(data)

            def entry(tag, typ, vals):
                cnt = len(vals)
                raw = struct.pack("<" + str(cnt) + _TYPE_FMT[typ], *vals)
                if len(raw) <= inline:
                    return (struct.pack(ehdr, tag, typ, cnt)
                            + raw.ljust(inline, b"\0"))
                ptr = f.tell()
                f.write(raw)  # out-of-line array, before the IFD
                return (struct.pack(ehdr, tag, typ, cnt)
                        + struct.pack(ptr_fmt, ptr))

            entries = [
                entry(W, 4, [width]), entry(H, 4, [height]),
                entry(BPS, 3, [bps]), entry(COMP, 3, [1]),
                entry(FILL_ORDER, 3, [fill_order]),
                entry(SPP, 3, [1]), entry(FMT, 3, [fmt]),
            ]
            if tile is None:
                entries += [entry(STRIP_OFF, off_typ, offsets),
                            entry(ROWS_PER_STRIP, 4, [height]),
                            entry(STRIP_CNT, off_typ, counts)]
            else:
                entries += [entry(TILE_W, 4, [tile[1]]),
                            entry(TILE_L, 4, [tile[0]]),
                            entry(TILE_OFF, off_typ, offsets),
                            entry(TILE_CNT, off_typ, counts)]
            entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])

            ifd_pos = f.tell()
            f.seek(ifd_ptr_pos)
            f.write(struct.pack(ptr_fmt, ifd_pos))
            f.seek(ifd_pos)
            f.write(struct.pack(cnt_hdr_fmt, len(entries)))
            for e in entries:
                f.write(e)
            ifd_ptr_pos = f.tell()
            f.write(struct.pack(ptr_fmt, 0))  # next-IFD pointer (patched or 0)
