"""8-bit RGB PNG encode/decode with the standard library (zlib + struct).

The encoder is the fallback of Image.save when the native codec
(native.png_encode) is unavailable; the decoder reads the committed
self-golden PNGs on machines without an imaging library.  Only what this
program writes and pins is supported: 8-bit RGB or RGBA, not interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(rgb: np.ndarray) -> bytes:
    """PNG bytes of an [H,W,3] uint8 image (filter type 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an [H,W,3] image, got {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int32)
    up = prior.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int32)
    up = prior.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """[H,W,3] uint8 image from PNG bytes (8-bit RGB/RGBA, alpha dropped)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(
            f"unsupported PNG: depth {depth}, color type {color}, "
            f"interlace {interlace}")
    bpp = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            row = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            row = line + prior
        elif ftype == 3:
            row = _average_row(line, prior, bpp)
        elif ftype == 4:
            row = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = row
        prior = row
    return out.reshape(h, w, bpp)[..., :3].copy()
