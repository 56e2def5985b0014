"""ctypes bindings for the native host-runtime library (native/).

The reference's host runtime is native Rust (tobj OBJ parsing, the `image`
PNG codec).  Here the equivalents live in
native/portrayer_native.cpp; this module builds (once, via make) and binds
them.  Every entry point has a pure-Python fallback at its call site, so
the framework works without a toolchain or zlib headers; set
PORTRAYER_NO_NATIVE=1 to force the fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB = None  # None = not tried; False = unavailable; CDLL = loaded

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE_DIR, "libportrayer_native.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB or None
    if os.environ.get("PORTRAYER_NO_NATIVE"):
        _LIB = False
        return None
    try:
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO)
            < os.path.getmtime(os.path.join(_NATIVE_DIR, "portrayer_native.cpp"))
        ):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"],
                check=True, capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_SO)
    except Exception:
        _LIB = False
        return None

    c_i64 = ctypes.c_int64
    c_i32 = ctypes.c_int32
    c_p = ctypes.c_void_p
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8ptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.pn_obj_load.restype = c_p
    lib.pn_obj_load.argtypes = [ctypes.c_char_p]
    lib.pn_obj_counts.restype = None
    lib.pn_obj_counts.argtypes = [
        c_p, ctypes.POINTER(c_i64), ctypes.POINTER(c_i64),
        ctypes.POINTER(c_i32), ctypes.POINTER(c_i32),
    ]
    lib.pn_obj_fill.restype = None
    lib.pn_obj_fill.argtypes = [c_p, dptr, dptr, dptr, iptr]
    lib.pn_obj_free.restype = None
    lib.pn_obj_free.argtypes = [c_p]

    lib.pn_png_encode.restype = c_i64
    lib.pn_png_encode.argtypes = [
        u8ptr, c_i32, c_i32, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.pn_free.restype = None
    lib.pn_free.argtypes = [c_p]

    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def obj_load(path) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool, bool]]:
    """Parse an OBJ file natively.

    Returns (positions [V,3], uvs [V,2], normals [V,3], tris [T,3],
    has_uv, has_norm) or None if the native path is unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    h = lib.pn_obj_load(os.fspath(path).encode())
    if not h:
        return None
    try:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        huv = ctypes.c_int32()
        hn = ctypes.c_int32()
        lib.pn_obj_counts(h, ctypes.byref(nv), ctypes.byref(nt),
                          ctypes.byref(huv), ctypes.byref(hn))
        V, T = nv.value, nt.value
        pos = np.empty((max(V, 1), 3), np.float64)
        uv = np.empty((max(V, 1), 2), np.float64)
        norm = np.empty((max(V, 1), 3), np.float64)
        tris = np.empty((max(T, 1), 3), np.int64)
        lib.pn_obj_fill(h, pos, uv, norm, tris)
        return (
            pos[:V], uv[:V], norm[:V], tris[:T],
            bool(huv.value), bool(hn.value),
        )
    finally:
        lib.pn_obj_free(h)


def png_encode(rgb: np.ndarray) -> Optional[bytes]:
    """Encode an [H,W,3] u8 array as PNG bytes (native); None = fallback."""
    lib = _load()
    if lib is None:
        return None
    h, w = rgb.shape[:2]
    out = ctypes.c_void_p()
    n = lib.pn_png_encode(
        np.ascontiguousarray(rgb, np.uint8), w, h, ctypes.byref(out)
    )
    if n < 0 or not out.value:
        return None
    try:
        return ctypes.string_at(out.value, n)
    finally:
        lib.pn_free(out)
