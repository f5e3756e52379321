"""Image output: float image -> PNG bytes/file.

This is the build's stand-in for the reference's presentation layer (the
RGBA8 screen texture + fullscreen blit, main.cpp:152-159 / 243-260 and
draw_screen_frag.glsl): device floats are gathered to host, clamped to [0,1],
quantized to 8-bit, and written as PNG. Row 0 of the render is the *bottom*
of the image (GL convention); PNG stores top-first, so rows are flipped here.

A native C++ encoder (native/imageio) is used when built — the analog of the
reference's C++ host-side image path — with this pure-Python zlib encoder as
the always-available fallback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(image) -> np.ndarray:
    """Clamp [0,1] float (H, W, 3) -> uint8, flipping rows to top-first."""
    img = np.asarray(image)
    img = np.clip(img, 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img[::-1]  # GL row 0 = bottom -> PNG row 0 = top


def to_uint8_device(image):
    """Jittable to_uint8: same clamp/quantize/row-flip on device, so a
    remote host fetches 1 byte per channel instead of 4 (the live viewer's
    frame loop fuses this into its per-frame jit, r4)."""
    import jax.numpy as jnp
    img = jnp.clip(image, 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(jnp.uint8)
    return img[::-1]


def to_yuv420_device(image):
    """Jittable [0,1] float (H, W, 3) -> (Y (H, W), Cb (H/2, W/2),
    Cr (H/2, W/2)) uint8 planes, rows flipped top-first.

    The live viewer's transport format: JPEG stores chroma at 4:2:0
    anyway, so subsampling ON DEVICE before the host fetch halves the
    fetched bytes (3 -> 1.5 per pixel) with no loss versus the JPEG the
    consumer was going to see. Full-range BT.601, matching JFIF/PIL 'YCbCr'. H and W must be even."""
    import jax.numpy as jnp
    img = jnp.clip(image, 0.0, 1.0)[::-1]          # row 0 = top, like to_uint8
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 + 0.5 * r - 0.418688 * g - 0.081312 * b

    def q(x):
        return (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)

    def pool2(x):   # 2x2 mean chroma subsample
        h, w = x.shape
        return x.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    return q(y), q(pool2(cb)), q(pool2(cr))


def pack_yuv420_device(image):
    """to_yuv420_device packed into ONE flat uint8 buffer (Y | Cb | Cr):
    one device->host transfer per frame instead of three."""
    import jax.numpy as jnp
    y, cb, cr = to_yuv420_device(image)
    return jnp.concatenate([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)])


def unpack_yuv420(buf, height: int, width: int):
    """Host-side inverse of pack_yuv420_device -> (Y, Cb, Cr) ndarrays."""
    buf = np.asarray(buf)
    hw = height * width
    q = hw // 4
    return (buf[:hw].reshape(height, width),
            buf[hw:hw + q].reshape(height // 2, width // 2),
            buf[hw + q:hw + 2 * q].reshape(height // 2, width // 2))


def yuv420_to_jpeg(y, cb, cr, quality: int = 85) -> bytes:
    """Host side: upsample chroma (nearest), merge to a PIL 'YCbCr' image,
    encode JPEG (PIL's JPEG encoder consumes YCbCr natively — no RGB
    round-trip)."""
    import io

    from PIL import Image
    cbu = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1)
    cru = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1)
    ycc = np.stack([np.asarray(y), cbu, cru], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(ycc, "YCbCr").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + \
        struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)


def encode_png_py(rgb8: np.ndarray) -> bytes:
    """Pure-Python PNG encoder for (H, W, 3) uint8."""
    h, w, c = rgb8.shape
    assert c == 3 and rgb8.dtype == np.uint8
    raw = b"".join(b"\x00" + rgb8[i].tobytes() for i in range(h))
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _png_chunk(b"IDAT", zlib.compress(raw, 6)),
        _png_chunk(b"IEND", b""),
    ])


def encode_png(rgb8: np.ndarray) -> bytes:
    """PNG-encode, preferring the native C++ encoder when available."""
    try:
        from openglraytracer_tpu.utils import native_imageio
        return native_imageio.encode_png(rgb8)
    except Exception:
        return encode_png_py(rgb8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8. The PNGs this repo writes (8-bit RGB,
    no interlace, filter 0 on every row) decode here with zlib alone; any
    other PNG goes through PIL."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, bit_depth, color, _, _, interlace = hdr
    if (bit_depth, color, interlace) == (8, 2, 0):
        rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                             np.uint8).reshape(h, 1 + 3 * w)
        if not rows[:, 0].any():
            return rows[:, 1:].reshape(h, w, 3).copy()
    return _decode_png_pil(data)


def _decode_png_pil(data: bytes) -> np.ndarray:
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)


def load_png(path: str) -> np.ndarray:
    """PNG -> float32 (H, W, 3) in [0, 1], rows flipped back to the render's
    GL convention (row 0 = bottom), so ``load_png(save_png(img)) ~= img`` and
    a loaded file can serve directly as an inverse-rendering target."""
    with open(path, "rb") as f:
        rgb8 = decode_png(f.read())
    return rgb8[::-1].astype(np.float32) / 255.0


def save_png(image, path: str, gather: bool = True) -> None:
    """Save a float (H, W, 3) image (device or host) to a PNG file."""
    if gather:
        from openglraytracer_tpu.parallel.distributed import gather_image
        image = gather_image(image)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(image)))
