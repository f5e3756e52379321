"""Camera / object transform math.

Reimplements the reference's GLSL matrix library (raytrace_compute.glsl:411-545)
in standard row-vector-on-the-right convention: a GLSL column-major initializer
``result[col][row] = v`` is the same matrix as ``M[row, col] = v`` here, so all
matrices below multiply column vectors ``M @ v`` exactly like the GLSL does.

A key departure from the reference: the GLSL rebuilds the projection,
view, and inverse view-projection matrices in every one of the 921,600 per-pixel
shader invocations (raytrace_compute.glsl:366-367, :383). Here they are computed
once per frame on 4x4 matrices (microseconds) and broadcast into ray
generation.

All functions are pure jnp and differentiable; ``euler_rotation_3x3`` is used
per-box inside the intersection kernels (vmapped over the box array).
"""

from __future__ import annotations

import jax.numpy as jnp

from openglraytracer_tpu.models.scene import Camera

DEG_TO_RAD = jnp.pi / 180.0

# 4x4 matrix products are computed at HIGHEST precision: at default
# precision the GPU may run them in TF32 (about three decimal digits), which
# would put ~1e-3 error into every camera matrix. These run once per frame,
# so the cost is nil.
import jax.lax as _lax


def _mm(a, b):
    return jnp.matmul(a, b, precision=_lax.Precision.HIGHEST)


def perspective_matrix(v_fov, aspect, near, far):
    """Perspective projection (reference calc_projection_matrix, :411-426)."""
    q = 1.0 / jnp.tan(DEG_TO_RAD * 0.5 * v_fov)
    a = q / aspect
    b = (near + far) / (near - far)
    c = (2.0 * near * far) / (near - far)
    z = jnp.zeros_like(q)
    one = jnp.ones_like(q)
    # GLSL: result[0][0]=A result[1][1]=q result[2][2]=B result[2][3]=-1 result[3][2]=C
    return jnp.stack([
        jnp.stack([a, z, z, z]),
        jnp.stack([z, q, z, z]),
        jnp.stack([z, z, b, c]),
        jnp.stack([z, z, -one, z]),
    ])


def translation_matrix(t):
    """(reference translation_matrix, :432-437)"""
    t = jnp.asarray(t)
    m = jnp.eye(4, dtype=t.dtype)
    return m.at[:3, 3].set(t)


def _rot_cs(deg):
    r = DEG_TO_RAD * deg
    return jnp.cos(r), jnp.sin(r)


def rotation_matrix_x(deg):
    """(reference rotation_matrix_x, :444-454)"""
    c, s = _rot_cs(deg)
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([one, z, z, z]),
        jnp.stack([z, c, -s, z]),
        jnp.stack([z, s, c, z]),
        jnp.stack([z, z, z, one]),
    ])


def rotation_matrix_y(deg):
    """(reference rotation_matrix_y, :460-470)"""
    c, s = _rot_cs(deg)
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, z, s, z]),
        jnp.stack([z, one, z, z]),
        jnp.stack([-s, z, c, z]),
        jnp.stack([z, z, z, one]),
    ])


def rotation_matrix_z(deg):
    """(reference rotation_matrix_z, :476-486)"""
    c, s = _rot_cs(deg)
    z = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    return jnp.stack([
        jnp.stack([c, -s, z, z]),
        jnp.stack([s, c, z, z]),
        jnp.stack([z, z, one, z]),
        jnp.stack([z, z, z, one]),
    ])


def euler_rotation_matrix(angles):
    """Rz(yaw) @ Rx(pitch) @ Ry(roll), angles = (pitch, yaw, roll) degrees.

    Matches reference rotation_matrix(vec3) (:492-503): yaw about z (up),
    then pitch about x (right), then roll about y (forward).
    """
    angles = jnp.asarray(angles)
    return _mm(_mm(rotation_matrix_z(angles[..., 1]),
                   rotation_matrix_x(angles[..., 0])),
               rotation_matrix_y(angles[..., 2]))


def euler_rotation_3x3(angles):
    """The 3x3 rotation block of euler_rotation_matrix (for normals/dirs)."""
    return euler_rotation_matrix(angles)[:3, :3]


def euler_rotation_3x3b(angles):
    """Batched componentwise Rz(yaw) @ Rx(pitch) @ Ry(roll): angles
    (..., 3) degrees -> (..., 3, 3). Identical math to euler_rotation_3x3
    but written as elementwise products so a per-RAY batch (millions in the
    analytic OBB VJP) stays elementwise instead of lowering 4x4 matmuls."""
    r = DEG_TO_RAD * jnp.asarray(angles)
    cp, sp = jnp.cos(r[..., 0]), jnp.sin(r[..., 0])   # pitch (x)
    cy, sy = jnp.cos(r[..., 1]), jnp.sin(r[..., 1])   # yaw   (z)
    cr, sr = jnp.cos(r[..., 2]), jnp.sin(r[..., 2])   # roll  (y)
    row0 = jnp.stack([cy * cr - sy * sp * sr, -sy * cp,
                      cy * sr + sy * sp * cr], axis=-1)
    row1 = jnp.stack([sy * cr + cy * sp * sr, cy * cp,
                      sy * sr - cy * sp * cr], axis=-1)
    row2 = jnp.stack([-cp * sr, sp, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def transform_matrix(position, angles):
    """translation(position) @ rotation(angles) (reference :529-532)."""
    return _mm(translation_matrix(position), euler_rotation_matrix(angles))


def view_matrix(position, angles):
    """inverse(transform(position, angles) @ Rx(90 deg)) — the right-handed
    z-up world convention of the reference (calc_view_matrix, :538-545).

    Computed without a general 4x4 inverse: for T @ R orthonormal,
    inverse = R^T @ T(-p)."""
    angles = jnp.asarray(angles)
    rot = _mm(euler_rotation_matrix(angles),
              rotation_matrix_x(jnp.asarray(90.0, angles.dtype)))
    inv = jnp.eye(4, dtype=rot.dtype)
    inv = inv.at[:3, :3].set(rot[:3, :3].T)
    inv = inv.at[:3, 3].set(-_mm(rot[:3, :3].T, jnp.asarray(position)))
    return inv


def camera_matrices(cam: Camera):
    """(proj, view, inverse(proj @ view)) — hoisted once per frame."""
    proj = perspective_matrix(cam.v_fov, cam.aspect, cam.near, cam.far)
    view = view_matrix(cam.position, cam.angles)
    inv_vp = jnp.linalg.inv(_mm(proj, view))
    return proj, view, inv_vp


def reflect(d, n):
    """GLSL reflect: d - 2*dot(n, d)*n (n assumed unit)."""
    return d - 2.0 * jnp.sum(n * d, axis=-1, keepdims=True) * n


def refract(d, n, eta):
    """GLSL refract(I, N, eta): returns 0 vector on total internal reflection.

    I, N unit vectors; eta = ratio of indices of refraction. Matches the GLSL
    spec formula used by the reference's refraction pass (:1023)."""
    cos_i = jnp.sum(n * d, axis=-1, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    # Double-where: sqrt has an infinite derivative at 0, and inf * 0 from the
    # masked branch would poison gradients with NaN at grazing incidence.
    k_safe = jnp.where(k > 0.0, k, 1.0)
    out = eta * d - (eta * cos_i + jnp.sqrt(k_safe)) * n
    return jnp.where(k > 0.0, out, jnp.zeros_like(out))
