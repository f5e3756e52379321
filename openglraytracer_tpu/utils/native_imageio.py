"""ctypes bindings for the native C++ image encoder (native/imageio.cpp).

The library is built from source with ``make -C native`` on first use into
native/build/ (gitignored); importers catch failure and fall back to the
pure-Python encoder (utils/image.py)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_lib = None
_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(_NATIVE, "build", "libimageio.so")


def build() -> str:
    """Build native/build/libimageio.so if it is missing or older than its
    source. Each build goes to a private directory and is renamed into
    place, so concurrent first uses cannot see a half-written library."""
    src = os.path.join(_NATIVE, "imageio.cpp")
    if os.path.exists(LIB_PATH) and \
            os.path.getmtime(LIB_PATH) >= os.path.getmtime(src):
        return LIB_PATH
    tmp = os.path.join("build", f"tmp-{os.getpid()}")
    subprocess.run(["make", "-s", "-C", _NATIVE, f"BUILD={tmp}"], check=True)
    os.replace(os.path.join(_NATIVE, tmp, "libimageio.so"), LIB_PATH)
    os.rmdir(os.path.join(_NATIVE, tmp))
    return LIB_PATH


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.oglrt_encode_png.restype = ctypes.c_long
    lib.oglrt_encode_png.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.oglrt_tonemap_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    lib.oglrt_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return lib


def tonemap_u8(image: np.ndarray) -> np.ndarray:
    """float (H, W, 3) [0,1] row-0-bottom -> uint8 (H, W, 3) row-0-top."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w, _ = img.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.oglrt_tonemap_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 top-first -> PNG bytes via the native encoder."""
    lib = _load()
    arr = np.ascontiguousarray(rgb8)
    h, w, _ = arr.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.oglrt_encode_png(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        ctypes.byref(out))
    if n < 0:
        raise RuntimeError("native PNG encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.oglrt_free(out)
