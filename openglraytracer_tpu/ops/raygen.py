"""Primary camera ray generation.

Vectorizes the reference's per-pixel ray construction (raytrace_compute.glsl:
372-393): NDC coords from integer pixel ids, two clip-space points at z=0.5 and
z=1.0 unprojected through inverse(proj @ view) with w-divide, ray origin at the
camera position, direction normalize(end - start).

Pixel convention follows GL dispatch: x = column in [0, W), y = row in [0, H)
with row 0 at the *bottom* of the image (the blit quad maps v=0 to the bottom).
``utils.image`` flips rows when writing PNGs.

Note the reference's integer division: ``(pixel.x - width/2) / (width/2)`` uses
C integer division for width/2 — replicated here with floor division so odd
resolutions match bit-for-bit.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.lax import Precision

from openglraytracer_tpu.models.scene import Camera
from openglraytracer_tpu.ops.transforms import camera_matrices


def pixel_ndc(height: int, width: int, dtype=jnp.float32):
    """Per-pixel NDC xy coords, shape (H, W) each."""
    half_w = width // 2
    half_h = height // 2
    px = jnp.arange(width, dtype=dtype)
    py = jnp.arange(height, dtype=dtype)
    x = (px - half_w) / half_w
    y = (py - half_h) / half_h
    return jnp.broadcast_to(x[None, :], (height, width)), \
        jnp.broadcast_to(y[:, None], (height, width))


def unproject(inv_vp, x, y, z):
    """inverse-viewproj @ (x, y, z, 1) with w-divide; x/y arbitrary shape."""
    shape = jnp.shape(x)
    ones = jnp.ones(shape, x.dtype)
    zs = jnp.full(shape, z, x.dtype)
    clip = jnp.stack([x, y, zs, ones], axis=-1)      # (..., 4)
    # HIGHEST precision: at default precision the GPU may run this in TF32
    world = jnp.matmul(clip, inv_vp.T, precision=Precision.HIGHEST)
    return world[..., :3] / world[..., 3:4]


def generate_rays(cam: Camera, height: int, width: int):
    """Returns (origins (H,W,3), dirs (H,W,3)) world-space primary rays."""
    _, _, inv_vp = camera_matrices(cam)
    x, y = pixel_ndc(height, width, dtype=cam.position.dtype)
    start = unproject(inv_vp, x, y, 0.5)
    end = unproject(inv_vp, x, y, 1.0)
    d = end - start
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    origins = jnp.broadcast_to(cam.position, d.shape)
    return origins, d
