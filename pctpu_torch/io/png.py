"""Minimal dependency-free PNG writer for 8-bit grayscale BEV images (the
port of ``pctpu/io/png.py``'s uint8 path, numpy + zlib, byte-identical).

The reference writes BEV layers with ``cv::imwrite`` (e.g.
reference/BatchMultiBevGen.cpp:318).  PNG bytes differ between encoders
(compression strategy), but the decoded pixels are what downstream consumers
read, and those are bit-identical.  The encoder writes the level-1 form of
``native/pctpu_io.cpp``, so it is the native writer's fallback byte for byte.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# --- RLE fixed-Huffman deflate (the native writer's level 1) -----------------
#
# Mirrors native/pctpu_io.cpp::deflate_rle_fixed bit-for-bit so the Python
# fallback stays byte-identical with the native writer (tested by
# tests/test_torch_multi_bev_e2e.py::test_python_writers_match_native).
# BEV rasters are mostly-zero, so dist-1 run matching in one BFINAL
# fixed-Huffman block captures nearly all the redundancy.

_RLE_TABLES = None


def _rle_fixed_tables():
    global _RLE_TABLES
    if _RLE_TABLES is None:
        def rev(c: int, n: int) -> int:
            r = 0
            for i in range(n):
                r |= ((c >> i) & 1) << (n - 1 - i)
            return r

        lit = [
            (rev(0x30 + v, 8), 8) if v < 144 else (rev(0x190 + v - 144, 9), 9)
            for v in range(256)
        ]
        base = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
                43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
        extra = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                 4, 4, 4, 4, 5, 5, 5, 5, 0]
        length = [None] * 259
        for l in range(3, 259):
            s = 28
            while base[s] > l:
                s -= 1
            sym = 257 + s
            if sym < 280:
                code, n = rev(sym - 256, 7), 7
            else:
                code, n = rev(0xC0 + sym - 280, 8), 8
            # huffman + extra bits (LSB-first) + 5 zero bits for distance
            # symbol 0 (distance 1)
            length[l] = (code | ((l - base[s]) << n), n + extra[s] + 5)
        _RLE_TABLES = (lit, length)
    return _RLE_TABLES


def _deflate_rle_fixed(raw: bytes) -> bytes:
    """Valid zlib stream: one BFINAL fixed-Huffman block, literals +
    distance-1 runs only (byte-identical to the native encoder)."""
    lit, length = _rle_fixed_tables()
    a = np.frombuffer(raw, np.uint8)
    n_total = len(a)
    out = bytearray(b"\x78\x01")  # CMF/FLG as the native encoder writes them
    acc, n = 3, 3  # BFINAL=1 then BTYPE=01, LSB-first
    if n_total:
        change = np.flatnonzero(a[1:] != a[:-1]) + 1
        starts = np.concatenate(([0], change)).tolist()
        ends = np.concatenate((change, [n_total])).tolist()
        for s, e in zip(starts, ends):
            lb, ln = lit[a[s]]
            acc |= lb << n
            n += ln
            rem = e - s - 1
            while rem >= 3:
                l = 258 if rem > 258 else rem
                pb, pn = length[l]
                acc |= pb << n
                n += pn
                rem -= l
            for _ in range(rem):
                acc |= lb << n
                n += ln
            while n >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                n -= 8
    n += 7  # end-of-block: symbol 256 = 7 zero bits
    while n >= 8:
        out.append(acc & 0xFF)
        acc >>= 8
        n -= 8
    if n:
        out.append(acc & 0xFF)
    out += struct.pack(">I", zlib.adler32(raw) & 0xFFFFFFFF)
    return bytes(out)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_gray_png(img: np.ndarray) -> bytes:
    """Encode a 2-D uint8 array as an 8-bit grayscale PNG."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)  # 8-bit grayscale
    raw = np.empty((h, w + 1), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) per scanline
    raw[:, 1:] = img
    idat = _deflate_rle_fixed(raw.tobytes())
    return _PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def write_gray_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray_png(img))


def decode_gray_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit grayscale PNG with filter-0 scanlines, as
    :func:`encode_gray_png` and the native writer produce them."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or color != 0:
                raise ValueError("only 8-bit grayscale PNGs supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w)
    if np.any(raw[:, 0] != 0):
        raise ValueError("only filter-0 scanlines supported")
    return raw[:, 1:].copy()


def read_gray_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray_png(f.read())
