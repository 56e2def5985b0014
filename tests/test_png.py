"""The standard-library PNG codec (portrayer_tpu/png.py) and Image.save's
fallback to it."""

import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest

from portrayer_tpu import native, png
from portrayer_tpu.render import Image

GOLDENS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "self_golden", "*.png")))


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        out.append((kind, body))
        pos += 12 + n
    return out


def test_encode_reads_back_with_zlib():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (33, 70, 3), dtype=np.uint8)
    data = png.encode(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks = _chunks(data)
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[0][1])
    assert (w, h, depth, color, interlace) == (70, 33, 8, 2, 0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = raw.reshape(33, 1 + 70 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(33, 70, 3), img)


def test_encode_decode_round_trip():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(png.decode(png.encode(img)), img)


def _filtered_png(img, ftype):
    """PNG bytes of img with every row filtered by `ftype` (spec §9)."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int32)
    out = []
    for y in range(h):
        up = x[y - 1] if y else np.zeros(w * 3, np.int32)
        left = np.concatenate([np.zeros(3, np.int32), x[y, :-3]])
        ul = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        if ftype == 0:
            pred = np.zeros_like(up)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((x[y] - pred) & 0xFF)
                   .astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_every_filter_type(ftype):
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    np.testing.assert_array_equal(png.decode(_filtered_png(img, ftype)), img)


@pytest.mark.parametrize("path", GOLDENS, ids=os.path.basename)
def test_decode_committed_golden_matches_pil(path):
    PILImage = pytest.importorskip("PIL.Image")
    with open(path, "rb") as f:
        data = f.read()
    ref = np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(png.decode(data), ref)


def test_image_save_falls_back_to_stdlib(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "png_encode", lambda rgb: None)
    img = Image(None, 6, 4)
    img.buffer = np.arange(72, dtype=np.uint8).reshape(4, 6, 3)
    path = img.save_as(tmp_path / "out.png")
    with open(path, "rb") as f:
        np.testing.assert_array_equal(png.decode(f.read()), img.buffer)


def test_decode_rejects_other_formats():
    with pytest.raises(ValueError):
        png.decode(b"GIF89a")
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.uint8))
