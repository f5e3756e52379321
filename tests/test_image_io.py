"""Image output: pure-Python and native C++ PNG encoders agree and produce
decodable PNGs."""

import struct
import zlib

import numpy as np
import pytest

from openglraytracer_tpu.utils.image import encode_png_py, to_uint8


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for our own filter-0 RGB PNGs."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    rows = []
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        assert row[0] == 0  # filter 0
        rows.append(np.frombuffer(row[1:], np.uint8))
    return np.stack(rows).reshape(h, w, 3)


def test_to_uint8_flip_and_clamp():
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = [2.0, -1.0, 0.5]  # bottom-left, clamps to [1, 0, 0.5]
    u8 = to_uint8(img)
    assert u8.shape == (2, 2, 3)
    np.testing.assert_array_equal(u8[1, 0], [255, 0, 128])  # flipped to bottom row


def test_python_png_roundtrip():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (17, 23, 3), np.uint8)
    out = _decode_png(encode_png_py(rgb))
    np.testing.assert_array_equal(out, rgb)


def test_native_png_matches_python():
    native = pytest.importorskip(
        "openglraytracer_tpu.utils.native_imageio")
    try:
        native._load()
    except OSError:
        pytest.skip("libimageio.so not built")
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (33, 41, 3), np.uint8)
    a = _decode_png(native.encode_png(rgb))
    b = _decode_png(encode_png_py(rgb))
    np.testing.assert_array_equal(a, b)


def test_native_tonemap_matches_python():
    native = pytest.importorskip(
        "openglraytracer_tpu.utils.native_imageio")
    try:
        native._load()
    except OSError:
        pytest.skip("libimageio.so not built")
    rng = np.random.default_rng(2)
    img = rng.normal(0.5, 0.5, (19, 27, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.tonemap_u8(img), to_uint8(img))


def test_yuv420_transport_matches_rgb_jpeg():
    """The viewer's device-side 4:2:0 transport (r5): a YUV420-transported
    frame decodes to (almost) the same pixels as the RGB-transported one —
    JPEG subsamples chroma to 4:2:0 anyway, so the transport loses nothing
    the consumer would have seen."""
    import io

    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from openglraytracer_tpu.utils.image import (to_uint8_device,
                                                 to_yuv420_device,
                                                 yuv420_to_jpeg)

    rng = np.random.default_rng(7)
    # smooth-ish field (JPEG murders white noise; the viewer ships renders)
    base = rng.random((9, 12, 3))
    img = jnp.asarray(np.repeat(np.repeat(base, 4, 0), 4, 1))  # (36, 48, 3)

    jpeg_yuv = yuv420_to_jpeg(*[np.asarray(p) for p in to_yuv420_device(img)],
                              quality=95)
    buf = io.BytesIO()
    Image.fromarray(np.asarray(to_uint8_device(img))).save(buf, "JPEG",
                                                           quality=95)
    a = np.asarray(Image.open(io.BytesIO(jpeg_yuv)).convert("RGB"), np.int16)
    b = np.asarray(Image.open(buf).convert("RGB"), np.int16)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert err.mean() < 3.0, f"mean {err.mean()}"
    assert np.percentile(err, 99) <= 12, f"p99 {np.percentile(err, 99)}"


def test_load_png_roundtrip_without_pil(tmp_path, monkeypatch):
    """The PNGs the repo writes load back with zlib alone (PIL blocked)."""
    import sys

    from openglraytracer_tpu.utils.image import load_png, save_png
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(1).random((9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_png(img, path, gather=False)
    np.testing.assert_allclose(load_png(path), img, atol=0.5 / 255 + 1e-6)


def test_native_library_builds_from_source():
    """libimageio.so is not committed: the first use builds it with make
    into native/build/ (gitignored)."""
    import os

    from openglraytracer_tpu.utils import native_imageio
    path = native_imageio.build()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "build"
