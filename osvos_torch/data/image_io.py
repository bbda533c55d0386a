"""Reading and writing DAVIS frames and annotations without OpenCV.

The card's machine has no OpenCV, so the port decodes DAVIS's JPEG frames
and PNG annotations itself, in numpy:

- ``imread(path)`` returns (H, W, 3) BGR uint8 and ``imread(path,
  gray=True)`` (H, W) uint8, the arrays of ``cv2.imread(path)`` and
  ``cv2.imread(path, 0)``. The format is chosen by the file's magic bytes.
- Baseline JPEG (SOF0/SOF1, 8-bit, 1 or 3 components, Huffman coded) is
  decoded as libjpeg does it, so that the arrays equal OpenCV's bit for
  bit: the integer inverse DCT of ``jidctint.c`` (vectorised over the
  blocks), "fancy" triangle-filter upsampling of 2x1 and 2x2 subsampled
  chroma (``jdsample.c``) and the integer YCbCr to RGB tables of
  ``jdcolor.c``; a gray read keeps the luma plane. Huffman decoding is a
  Python loop over symbols that looks each one up in a table indexed by
  the next 16 bits of the stream. Progressive and arithmetic-coded files
  raise.
- PNG: 8-bit gray, gray + alpha, RGB, RGBA and palette images, filter
  types 0-4, not interlaced; alpha is dropped, and color becomes gray as
  OpenCV's PNG reader makes it (libpng's ``png_set_rgb_to_gray`` with
  weights 0.299 and 0.587 in 15-bit fixed point, truncated).
- BMP: uncompressed (BI_RGB) 8-bit palette, 24-bit and 32-bit images,
  bottom-up or top-down; the fourth byte of a 32-bit pixel is dropped, and
  color becomes gray as OpenCV's BMP reader makes it (weights 0.299, 0.587
  and 0.114 in 14-bit fixed point, rounded; a palette is made gray entry by
  entry). RLE and bit-field files raise.
- ``write_png_rgb`` writes an (H, W, 3) RGB PNG (the overlays) and
  ``encode_jpeg`` a baseline 4:2:0 JPEG with the example tables of the
  standard's Annex K scaled as libjpeg scales them for a quality, which
  ``data/synthetic.generate`` needs to write a DAVIS-layout tree.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_BMP_MAGIC = b"BM"

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class UnsupportedImage(ValueError):
    """A well-formed JPEG, PNG or BMP that this reader does not decode,
    though OpenCV would (progressive JPEG, 16-bit PNG, RLE BMP, ...)."""


def imread(path: str, gray: bool = False) -> np.ndarray:
    """``cv2.imread(path)`` (BGR uint8) or, with ``gray``,
    ``cv2.imread(path, 0)``, for baseline JPEG, 8-bit PNG and uncompressed
    BMP files."""
    with open(path, "rb") as f:
        data = f.read()
    return imdecode(data, gray)


def imdecode(data: bytes, gray: bool = False) -> np.ndarray:
    """The image in ``data``. Raises ``UnsupportedImage`` for a file this
    reader does not decode, and ``ValueError`` for what OpenCV cannot read
    either: neither JPEG, PNG nor BMP, or truncated or corrupt."""
    if data[:2] == _JPEG_MAGIC:
        decode = decode_jpeg
    elif data[:8] == _PNG_MAGIC:
        decode = decode_png
    elif data[:2] == _BMP_MAGIC:
        decode = decode_bmp
    else:
        raise ValueError("not a JPEG, PNG or BMP file")
    try:
        return decode(data, gray)
    except UnsupportedImage:
        raise
    except (ValueError, IndexError, KeyError, StopIteration, struct.error,
            zlib.error) as e:
        raise ValueError(f"truncated or corrupt image: {e}") from e


# ---------------------------------------------------------------------------
# JPEG decoding
# ---------------------------------------------------------------------------


def _huffman_lut(counts: List[int], symbols: bytes) -> List[int]:
    """A 65536-entry table: for the next 16 bits of the stream, (code
    length << 8) | symbol of the code they start with, 0 where none does."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            span = 1 << (16 - length)
            start = code << (16 - length)
            lut[start:start + span] = [(length << 8) | symbols[k]] * span
            code += 1
            k += 1
        code <<= 1
    return lut


def _byte_windows(seg: bytes) -> List[int]:
    """For each byte of the unstuffed segment, the 24 bits that start there
    (zeros past its end): the 16 bits at bit position p are
    ``(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF``."""
    b = np.frombuffer(seg + b"\x00\x00\x00", np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos`` split at its restart markers,
    byte stuffing removed, and the offset of the marker that ends it."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG: entropy-coded data runs off the file")
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
            continue
        if nxt == 0xFF:  # fill bytes before a marker
            pos = i + 1
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            start = pos = i + 2
            continue
        return segs, i


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0  # Huffman tables of the current scan
        self.coefs: List[int] = []
        self.bw = self.bh = 0  # blocks per row and column


def _decode_scan(segs: List[bytes], comps: List[_Component],
                 tables: Dict[Tuple[int, int], List[int]], restart: int,
                 mcux: int, mcuy: int, hmax: int, vmax: int, width: int,
                 height: int) -> None:
    """Huffman-decode one baseline scan into the components' coefficient
    lists (natural order, quantized)."""
    zz = ZIGZAG.tolist()
    if len(comps) == 1:  # non-interleaved: one block per MCU
        c = comps[0]
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        units = [(c, 0, 0)]
        n_mcu, per_row = bw * bh, bw
    else:
        units = [(c, dy, dx) for c in comps for dy in range(c.v)
                 for dx in range(c.h)]
        n_mcu, per_row = mcux * mcuy, mcux
    plan = [(comps.index(c), c.h if len(comps) > 1 else 1,
             c.v if len(comps) > 1 else 1, dy, dx,
             tables[(0, c.td)], tables[(1, c.ta)]) for c, dy, dx in units]
    preds = [0] * len(comps)
    seg_i, win, pos = 0, _byte_windows(segs[0]), 0
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            seg_i += 1
            if seg_i >= len(segs):
                raise ValueError("JPEG: missing restart marker")
            win, pos, preds = _byte_windows(segs[seg_i]), 0, [0] * len(comps)
        my, mx = divmod(m, per_row)
        for ci, ch, cv, dy, dx, dc_lut, ac_lut in plan:
            comp = comps[ci]
            base = ((my * cv + dy) * comp.bw + mx * ch + dx) * 64
            coefs = comp.coefs
            e = dc_lut[(win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: bad Huffman code")
            pos += e >> 8
            s = e & 0xFF
            if s:
                v = ((win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                preds[ci] += _extend(v, s)
                pos += s
            coefs[base] = preds[ci]
            k = 1
            while k < 64:
                e = ac_lut[(win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: bad Huffman code")
                pos += e >> 8
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise ValueError("JPEG: coefficient index past 63")
                    v = ((win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
                    coefs[base + zz[k]] = _extend(v, s)
                    pos += s
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


# jidctint.c constants (CONST_BITS = 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(c: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of ``jpeg_idct_islow`` on the eight int64 inputs
    ``c[0..7]`` (arrays), descaled by ``shift``."""
    f = _F
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return [(o + half) >> shift for o in outs]


# libjpeg's post-IDCT range limit: sample = table[x & 1023], which is
# clamp(x + 128, 0, 255) for x in [-512, 511]
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255),
                         np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` of (B, 64) quantized coefficients (natural order)
    with the (64,) quantization table: (B, 8, 8) uint8 samples."""
    d = coefs.astype(np.int64).reshape(-1, 8, 8) * quant.astype(np.int64).reshape(8, 8)
    cols = _idct_1d([d[:, r, :] for r in range(8)], 13 - 2)  # pass 1
    ws = np.stack(cols, axis=1)  # (B, 8 rows, 8 cols)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)
    return _RANGE[out & 1023]


def _upsample_h2v1(s: np.ndarray, dw: int) -> np.ndarray:
    """``h2v1_fancy_upsample`` of (rows, >= dw) samples."""
    s = s[:, :dw].astype(np.int32)
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    even = (3 * s + left + 1) >> 2
    odd = (3 * s + right + 2) >> 2
    even[:, 0] = s[:, 0]
    odd[:, -1] = s[:, -1]
    return np.stack([even, odd], axis=2).reshape(s.shape[0], 2 * dw)


def _upsample_h2v2(s: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``h2v2_fancy_upsample`` of (>= dh, >= dw) samples: rows above the
    first and below the last repeat them, as libjpeg's context rows do."""
    s = s[:dh, :dw].astype(np.int32)
    above = np.concatenate([s[:1], s[:-1]], axis=0)
    below = np.concatenate([s[1:], s[-1:]], axis=0)
    out = []
    for t in (3 * s + above, 3 * s + below):
        left = np.concatenate([t[:, :1], t[:, :-1]], axis=1)
        right = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)
        even = (3 * t + left + 8) >> 4
        odd = (3 * t + right + 7) >> 4
        even[:, 0] = (4 * t[:, 0] + 8) >> 4
        odd[:, -1] = (4 * t[:, -1] + 7) >> 4
        out.append(np.stack([even, odd], axis=2).reshape(dh, 2 * dw))
    return np.stack(out, axis=1).reshape(2 * dh, 2 * dw)


def _ycc_tables():
    """``build_ycc_rgb_table`` of jdcolor.c (SCALEBITS = 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``ycc_rgb_convert`` of uint8 planes, as (H, W, 3) BGR uint8."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    """A baseline JPEG as (H, W, 3) BGR uint8, or (H, W) uint8 with
    ``gray``, equal to OpenCV's (libjpeg-turbo's) decode."""
    if data[:2] != _JPEG_MAGIC:
        raise ValueError("not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    tables: Dict[Tuple[int, int], List[int]] = {}
    comps: List[_Component] = []
    restart = 0
    width = height = hmax = vmax = mcux = mcuy = 0
    pos, scanned = 2, False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                raw = body[i + 1:i + 1 + size]
                vals = (np.frombuffer(raw, ">u2") if pq
                        else np.frombuffer(raw, np.uint8)).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                i += 1 + size
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                tables[(tc, th)] = _huffman_lut(counts, body[i + 17:i + 17 + n])
                i += 17 + n
        elif marker in (0xC0, 0xC1):  # baseline / extended sequential
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8 or nf not in (1, 3) or height == 0:
                raise UnsupportedImage(f"JPEG: {precision}-bit, {nf} components, "
                                 f"height {height} is not supported")
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4,
                                body[7 + 3 * k] & 15, body[8 + 3 * k])
                     for k in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.coefs = [0] * (c.bw * c.bh * 64)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise UnsupportedImage(f"JPEG: SOF{marker - 0xC0} (progressive, "
                             "lossless or arithmetic coding) is not supported")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:  # SOS
            if not comps:
                raise ValueError("JPEG: scan before the frame header")
            ns = body[0]
            scan = []
            for k in range(ns):
                comp = next(c for c in comps if c.id == body[1 + 2 * k])
                comp.td, comp.ta = body[2 + 2 * k] >> 4, body[2 + 2 * k] & 15
                scan.append(comp)
            segs, pos = _scan_segments(data, pos)
            _decode_scan(segs, scan, tables, restart, mcux, mcuy, hmax, vmax,
                         width, height)
            scanned = True
        # APPn, COM and other segments are skipped
    if not scanned:
        raise ValueError("JPEG: no scan")

    planes = []
    for c in comps[:1] if gray else comps:
        blocks = idct_islow(np.array(c.coefs, np.int64).reshape(-1, 64),
                            quant[c.tq])
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(c.bh * 8, c.bw * 8)
        dw = -(-width * c.h // hmax)
        dh = -(-height * c.v // vmax)
        fx, fy = hmax // c.h, vmax // c.v
        if (fx, fy) == (1, 1):
            full = plane[:dh, :dw]
        elif (fx, fy) == (2, 1):
            full = _upsample_h2v1(plane[:dh], dw)
        elif (fx, fy) == (2, 2):
            full = _upsample_h2v2(plane, dw, dh)
        else:
            raise UnsupportedImage(f"JPEG: {fx}x{fy} chroma subsampling is not "
                             "supported")
        planes.append(full[:height, :width].astype(np.uint8))
    if gray:
        return np.ascontiguousarray(planes[0])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    return ycc_to_bgr(*planes)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

# OpenCV's BGR to gray for 8-bit images (imgcodecs ``icvCvt_BGR2Gray``):
# 14-bit fixed-point weights, rounded
_BMP_SHIFT = 14
_BMP_R = int(0.299 * (1 << _BMP_SHIFT) + 0.5)
_BMP_G = int(0.587 * (1 << _BMP_SHIFT) + 0.5)
_BMP_B = (1 << _BMP_SHIFT) - _BMP_R - _BMP_G
_BMP_RLE = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG"}


def bgr_to_gray_bmp(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's 8-bit BGR to gray: (B bc + G gc + R rc + 2^13) >> 14."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((_BMP_B * b + _BMP_G * g + _BMP_R * r + (1 << (_BMP_SHIFT - 1)))
            >> _BMP_SHIFT).astype(np.uint8)


def decode_bmp(data: bytes, gray: bool = False) -> np.ndarray:
    """An uncompressed BMP as (H, W, 3) BGR uint8, or (H, W) uint8 with
    ``gray``, as OpenCV's BMP reader returns it: BI_RGB at 8 bits with a
    palette (entries it lacks are black), 24 or 32 bits (the fourth byte
    dropped), rows bottom-up or, with a negative height, top-down."""
    if data[:2] != _BMP_MAGIC:
        raise ValueError("not a BMP file")
    offset, header = struct.unpack_from("<II", data, 10)
    if header == 12:  # OS/2 BITMAPCOREHEADER: no compression, 3-byte palette
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        compression, used, entry = 0, 0, 3
    elif header >= 40:
        w, h, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
        used = struct.unpack_from("<I", data, 46)[0]
        entry = 4
    else:
        raise ValueError(f"BMP: header of {header} bytes")
    if compression in _BMP_RLE or compression == 3 or compression == 6:
        kind = _BMP_RLE.get(compression, "bit-field")
        raise UnsupportedImage(f"BMP: {kind} compression is not supported")
    if compression != 0:
        raise ValueError(f"BMP: compression {compression}")
    if bpp not in (8, 24, 32):
        raise UnsupportedImage(f"BMP: {bpp}-bit pixels are not supported")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"BMP: {w}x{h} pixels")
    stride = (w * bpp // 8 + 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError("BMP: pixel data cut short")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        count = used or 256
        start = 14 + header
        table = np.frombuffer(data[start:start + count * entry], np.uint8)
        table = table[:len(table) // entry * entry].reshape(-1, entry)[:256, :3]
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(table)] = table
        index = rows[:, :w]
        return (bgr_to_gray_bmp(palette) if gray else palette)[index]
    bgr = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[..., :3]
    return bgr_to_gray_bmp(bgr) if gray else np.ascontiguousarray(bgr)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587): 15-bit weights
_GRAY_R = 29900 * 32768 // 100000
_GRAY_G = 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) uint8 scanlines of a non-interlaced 8-bit image."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0,
                            dtype=np.int64).reshape(-1).astype(np.uint8)
        elif ftype == 2:
            cur = line + prior
        elif ftype in (3, 4):
            cur_l = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (cur_l[i] + pred) & 0xFF
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def rgb_to_gray_png(rgb: np.ndarray) -> np.ndarray:
    """libpng's 8-bit rgb_to_gray without gamma: a pixel with R = G = B
    keeps its value, others take (rc R + gc G + bc B) >> 15."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    mixed = (_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15
    same = (r == g) & (r == b)
    return np.where(same, r, mixed).astype(np.uint8)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """An 8-bit PNG as (H, W, 3) BGR uint8, or (H, W) uint8 with ``gray``,
    as OpenCV's PNG reader returns it."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, idat, hdr, palette = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS:
        raise UnsupportedImage(f"PNG: bit depth {depth}, color type {color} is not "
                         "supported")
    if interlace:
        raise UnsupportedImage("PNG: interlaced files are not supported")
    ch = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        px = palette[px[..., 0]]
    elif color in (4, 6):
        px = px[..., :-1]
    if px.shape[-1] == 1:
        return px[..., 0] if gray else np.repeat(px, 3, axis=2)
    if gray:
        return rgb_to_gray_png(px)
    return np.ascontiguousarray(px[..., ::-1])


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W) gray or (H, W, 3) RGB uint8 array as an 8-bit PNG, filter
    type 0 on every row."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        color, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color, rows = 2, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) RGB uint8 image as a PNG."""
    _write(path, encode_png(rgb))


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as a grayscale PNG."""
    if np.ndim(img) != 2:
        raise ValueError(f"expected an (H, W) map, got shape {np.shape(img)}")
    _write(path, encode_png(img))


def _write(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# JPEG encoding (baseline, 4:2:0, Annex K tables)
# ---------------------------------------------------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# (bits, values) of the Annex K.3 tables: DC luma, AC luma, DC chroma, AC chroma
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_DC_C_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_C_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_C_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")


def _huffman_codes(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a table's (bits, values)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, clamped to
    1..255 (baseline)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _fdct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


_DCT = _fdct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 64) raster blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(
        h // 8, w // 8, 64)


def _symbols(q: np.ndarray, dc_tab, ac_tab, prev_dc: np.ndarray):
    """Sort keys, codes and lengths of the Huffman symbols of the (B, 64)
    zigzag-ordered blocks ``q``; ``prev_dc`` is each block's DC predictor."""
    b = q.shape[0]
    keys, codes, lens = [], [], []

    def emit(key, sym, tab, extra, n_extra):
        code_of, len_of = tab
        keys.append(key)
        codes.append((code_of[sym] << n_extra) | extra)
        lens.append(len_of[sym] + n_extra)

    def size_bits(v):
        mag = np.abs(v)
        size = np.zeros_like(v)
        nz = mag > 0
        size[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
        extra = np.where(v < 0, v + (1 << size) - 1, v) & ((1 << size) - 1)
        return size, extra

    idx = np.arange(b, dtype=np.int64)
    size, extra = size_bits(q[:, 0] - prev_dc)
    emit(idx * 4096, size, dc_tab, extra, size)
    blk, pos = np.nonzero(q[:, 1:])
    pos = pos + 1
    prev = np.empty_like(pos)
    if pos.size:
        prev[0] = 0
        prev[1:] = np.where(blk[1:] == blk[:-1], pos[:-1], 0)
    run = pos - prev - 1
    for j in range(3):  # ZRL symbols for runs of 16 zeros
        has = run >= 16 * (j + 1)
        emit(blk[has] * 4096 + pos[has] * 32 + j, np.full(has.sum(), 0xF0),
             ac_tab, np.zeros(has.sum(), np.int64), np.zeros(has.sum(), np.int64))
    size, extra = size_bits(q[blk, pos])
    emit(blk * 4096 + pos * 32 + 16, (run % 16) * 16 + size, ac_tab, extra, size)
    last = np.zeros(b, np.int64)
    np.maximum.at(last, blk, pos)
    eob = last < 63
    emit(idx[eob] * 4096 + 64 * 32, np.zeros(eob.sum(), np.int64), ac_tab,
         np.zeros(eob.sum(), np.int64), np.zeros(eob.sum(), np.int64))
    return (np.concatenate(keys), np.concatenate(codes), np.concatenate(lens))


def _pack_bits(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """The concatenated (code, length) bit strings, padded with ones to a
    byte, with 0xFF bytes stuffed."""
    bits = np.unpackbits(codes.astype(">u4").view(np.uint8).reshape(-1, 4),
                         axis=1)
    keep = np.arange(32)[None, :] >= (32 - lens)[:, None]
    stream = bits[keep]
    stream = np.concatenate([stream, np.ones(-stream.size % 8, np.uint8)])
    return np.packbits(stream).tobytes().replace(b"\xff", b"\xff\x00")


def encode_jpeg(bgr: np.ndarray, quality: int = 95) -> bytes:
    """A baseline JFIF JPEG of an (H, W, 3) BGR uint8 image, 4:2:0, with the
    Annex K tables scaled to ``quality`` as libjpeg scales them."""
    img = np.asarray(bgr, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) BGR, got {img.shape}")
    h, w = img.shape[:2]
    b, g, r = (img[..., i].astype(np.float64) for i in range(3))
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    mh, mw = -(-h // 16) * 16, -(-w // 16) * 16
    padded = [np.pad(p, ((0, mh - h), (0, mw - w)), mode="edge") for p in planes]
    chroma = [p.reshape(mh // 2, 2, mw // 2, 2).mean(axis=(1, 3)) for p in padded[1:]]
    qy, qc = quality_table(_LUMA_Q, quality), quality_table(_CHROMA_Q, quality)

    def quantize(plane, qt):
        blocks = _blocks(plane - 128.0)
        coef = _DCT @ blocks.reshape(-1, 8, 8) @ _DCT.T
        return np.rint(coef.reshape(blocks.shape) / qt.reshape(64)).astype(np.int64)

    y = quantize(padded[0], qy)  # (mh/8, mw/8, 64)
    cb, cr = (quantize(p, qc) for p in chroma)
    my, mx = mh // 16, mw // 16
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    yb = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    mcu = np.concatenate([yb, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)], axis=1)
    zz = mcu[..., ZIGZAG]  # (MCUs, 6, 64)
    dc_l = _huffman_codes(_DC_BITS, _DC_VALS)
    ac_l = _huffman_codes(_AC_BITS, _AC_VALS)
    dc_c = _huffman_codes(_DC_C_BITS, _DC_VALS)
    ac_c = _huffman_codes(_AC_C_BITS, _AC_C_VALS)
    parts = []
    for comp, units, dc_tab, ac_tab in ((0, range(0, 4), dc_l, ac_l),
                                        (1, [4], dc_c, ac_c),
                                        (2, [5], dc_c, ac_c)):
        q = zz[:, list(units)].reshape(-1, 64)
        dcs = q[:, 0]
        prev = np.concatenate([[0], dcs[:-1]])
        keys, codes, lens = _symbols(q, dc_tab, ac_tab, prev)
        # the block's place in the stream: MCU, then unit within the MCU
        block = keys // 4096
        unit = np.asarray(list(units))[block % len(units)]
        keys = ((block // len(units)) * 6 + unit) * 4096 + keys % 4096
        parts.append((keys, codes, lens))
    keys, codes, lens = (np.concatenate(x) for x in zip(*parts))
    order = np.argsort(keys, kind="stable")
    scan = _pack_bits(codes[order], lens[order])

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    def dht(tc, th, bits, vals):
        return bytes([tc << 4 | th]) + bytes(bits) + bytes(vals)

    out = [_JPEG_MAGIC,
           seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           seg(0xDB, bytes([0]) + bytes(qy[ZIGZAG].tolist())
               + bytes([1]) + bytes(qc[ZIGZAG].tolist())),
           seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           seg(0xC4, dht(0, 0, _DC_BITS, _DC_VALS) + dht(1, 0, _AC_BITS, _AC_VALS)
               + dht(0, 1, _DC_C_BITS, _DC_VALS)
               + dht(1, 1, _AC_C_BITS, _AC_C_VALS)),
           seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path: str, bgr: np.ndarray, quality: int = 95) -> None:
    """Write an (H, W, 3) BGR uint8 image as a baseline 4:2:0 JPEG."""
    _write(path, encode_jpeg(bgr, quality))
