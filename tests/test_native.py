"""Native host-runtime components vs their Python fallbacks.

The reference's host runtime is native (tobj OBJ parsing, the `image` PNG
codec in Rust); native/portrayer_native.cpp holds this framework's
equivalents.  These tests pin the native paths to the Python reference
implementations (the equivalence-oracle pattern of
src/kdtree/kdmesh.rs:99-166)."""

import io
import os

import numpy as np
import pytest

from portrayer_tpu import native
from portrayer_tpu.scene.mesh import MeshData

ASSETS = os.environ.get("PORTRAYER_ASSETS", "/root/reference/assets")

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@needs_native
@pytest.mark.parametrize("name", ["monkey.obj", "teapot.obj", "castle.obj"])
def test_obj_native_matches_python(name):
    path = os.path.join(ASSETS, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not in reference assets")
    nat = MeshData.load_obj(path)
    py = MeshData._load_obj_py(path)
    np.testing.assert_allclose(nat.positions, py.positions)
    np.testing.assert_array_equal(nat.triangles, py.triangles)
    np.testing.assert_allclose(nat.normals, py.normals)
    np.testing.assert_allclose(nat.tex_coords, py.tex_coords)
    np.testing.assert_allclose(nat.bounds_min, py.bounds_min)
    np.testing.assert_allclose(nat.bounds_max, py.bounds_max)


@needs_native
def test_png_roundtrip():
    from PIL import Image as PILImage

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (33, 70, 3), dtype=np.uint8)
    data = native.png_encode(img)
    assert data is not None and data[:8] == b"\x89PNG\r\n\x1a\n"
    decoded = np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decoded, img)


def test_fallbacks_when_disabled(monkeypatch, tmp_path):
    monkeypatch.setenv("PORTRAYER_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available()
    assert native.obj_load("/nonexistent") is None
    assert native.png_encode(np.zeros((4, 4, 3), np.uint8)) is None
    monkeypatch.setattr(native, "_LIB", None)
