"""Ray-primitive intersection: branch-free, chunked, differentiable.

Reimplements the reference's intersection layer (raytrace_compute.glsl):
  * intersect_sphere_object  (:583-640)  -> sphere candidates
  * intersect_box_object     (:647-724)  -> oriented-box (OBB slab) candidates
  * get_closest_collision    (:738-782)  -> closest_hit (running min)
plus an analytic infinite-plane primitive the benchmark configs require.

Design decisions (vs the reference's per-pixel scalar loop with divergent
type dispatch):

  * Everything is dense math over (R rays x C objects) blocks with jnp.where
    masking — no branches, so XLA fuses it into elementwise kernels and the
    whole thing is differentiable.
  * Objects are scanned in fixed-size CHUNKS with a running minimum, so peak
    memory is R x chunk instead of R x N (a 2048^2 image x 4096 spheres would
    otherwise materialize 17G-element intermediates).
  * Tie-breaking matches the reference: ``c.t < closest`` keeps the *first*
    object at equal t (:773); jnp.argmin also returns the first minimum, and
    cross-chunk updates use strict <.
  * Misses are encoded as t = INF_T; a final hit requires t < MISS_T = 10000,
    matching the reference's ``closest = 10000`` initial bound (:740).
  * All divisions/sqrts are guarded (the "double-where" pattern) so gradients
    never see NaN even for degenerate rays — the GLSL leans on IEEE inf
    semantics for axis-parallel rays (:661-662); we clamp instead and test it.

Object id convention: spheres occupy [0, N), boxes [N, N+M), planes
[N+M, N+M+P) in the global object index space.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from openglraytracer_tpu.models.scene import MISS_T, Boxes, Planes, Scene, Spheres
from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b

INF_T = 1.0e10
_DIV_EPS = 1.0e-12
_SQRT_EPS = 1.0e-20


class Hit(NamedTuple):
    """The reference's Collision struct (:561-573), SoA over rays."""

    t: jnp.ndarray         # (R,) hit distance; INF_T on miss
    p: jnp.ndarray         # (R, 3) world hit point
    n: jnp.ndarray         # (R, 3) world unit normal (flipped when inside)
    inside: jnp.ndarray    # (R,) bool — ray started inside the object
    material_id: jnp.ndarray  # (R,) int32 (0 on miss)
    obj_id: jnp.ndarray    # (R,) int32 global object index (-1 on miss)
    hit: jnp.ndarray       # (R,) bool


def _safe_div(a, b):
    """a / b with |b| clamped away from 0 (sign-preserving)."""
    b_safe = jnp.where(jnp.abs(b) < _DIV_EPS,
                       jnp.where(b < 0, -_DIV_EPS, _DIV_EPS), b)
    return a / b_safe


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, _SQRT_EPS))


def _safe_normalize(v, axis=-1):
    n2 = jnp.sum(v * v, axis=axis, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, _SQRT_EPS))


# All K=3 contractions below are written as explicit component arithmetic
# rather than einsum/dot: a dot at default precision may run on the tensor
# cores in TF32 (about three decimal digits — hit distances would be off by
# ~1e-3 relative), and a K=3 dot is not worth a matrix unit anyway.
# Component math stays elementwise in full f32 and fuses with its neighbours.

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _rot_apply(rot, vx, vy, vz):
    """rot: (..., 3, 3); v components broadcastable -> rotated components."""
    rx = rot[..., 0, 0] * vx + rot[..., 0, 1] * vy + rot[..., 0, 2] * vz
    ry = rot[..., 1, 0] * vx + rot[..., 1, 1] * vy + rot[..., 1, 2] * vz
    rz = rot[..., 2, 0] * vx + rot[..., 2, 1] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz


def _rot_apply_t(rot, vx, vy, vz):
    """Apply rot^T (world -> local for an orthonormal rotation)."""
    rx = rot[..., 0, 0] * vx + rot[..., 1, 0] * vy + rot[..., 2, 0] * vz
    ry = rot[..., 0, 1] * vx + rot[..., 1, 1] * vy + rot[..., 2, 1] * vz
    rz = rot[..., 0, 2] * vx + rot[..., 1, 2] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz


# ---------------------------------------------------------------------------
# Per-type candidate computations. Each returns (t, n, inside) with
# t = INF_T on miss; shapes (R, C), (R, C, 3), (R, C).
# ---------------------------------------------------------------------------

def sphere_candidates(o, d, center, radius, valid, with_normals=True):
    """Ray-sphere quadratic (reference intersect_sphere_object, :583-640).

    o, d: (R, 3); center: (C, 3); radius, valid: (C,).
    Handles unnormalized d (shadow rays use dir = light_pos - p, :809) and the
    inside-the-sphere case (t_near < 0 -> use t_far, flip normal)."""
    ocx = o[:, None, 0] - center[None, :, 0]           # (R, C)
    ocy = o[:, None, 1] - center[None, :, 1]
    ocz = o[:, None, 2] - center[None, :, 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]       # (R, 1)
    qa = _dot3(dx, dy, dz, dx, dy, dz)                 # (R, 1)
    qb = 2.0 * _dot3(dx, dy, dz, ocx, ocy, ocz)        # (R, C)
    qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (radius * radius)[None, :]
    qd = qb * qb - 4.0 * qa * qc

    ok = (qd >= 0.0) & (qa > _DIV_EPS) & valid[None, :]
    sq = jnp.where(ok, _safe_sqrt(qd), 0.0)
    inv_2qa = _safe_div(0.5, qa)
    t1 = (-qb + sq) * inv_2qa
    t2 = (-qb - sq) * inv_2qa
    t_near = jnp.minimum(t1, t2)
    t_far = jnp.maximum(t1, t2)

    ok = ok & (t_far >= 0.0)
    inside = ok & (t_near < 0.0)
    t = jnp.where(inside, t_far, t_near)
    # get_closest_collision rejects t <= 0 (:753)
    ok = ok & (t > 0.0)
    t = jnp.where(ok, t, INF_T)

    if not with_normals:
        return t, None, inside
    # n = normalize(p - center) where p = o + t*d; computed componentwise.
    # t is INF_T on miss — mask it before use so no inf*0 NaNs appear.
    tn = jnp.where(ok, t, 0.0)
    nx = ocx + tn * dx
    ny = ocy + tn * dy
    nz = ocz + tn * dz
    inv_len = jax.lax.rsqrt(jnp.maximum(_dot3(nx, ny, nz, nx, ny, nz),
                                        _SQRT_EPS))
    flip = jnp.where(inside, -inv_len, inv_len) * ok.astype(t.dtype)
    n = jnp.stack([nx * flip, ny * flip, nz * flip], axis=-1)
    return t, n, inside


def box_candidates(o, d, mins, maxs, position, rot, valid, with_normals=True):
    """Oriented-box slab test (reference intersect_box_object, :647-724).

    o, d: (R, 3); mins/maxs/position: (C, 3); rot: (C, 3, 3) local->world
    rotation (the 3x3 block of translation @ euler rotation); valid: (C,).

    The reference transforms the ray into box local space with a full 4x4
    inverse (:652); for a rigid transform the inverse is R^T (x - pos), which
    is what we use. The world normal transform transpose(inverse(mat3(M)))
    (:718) equals R for an orthonormal R."""
    # world -> local: Rot^T (x - pos); componentwise, rot broadcast (1, C, 3, 3)
    rb = rot[None]
    wx = o[:, None, 0] - position[None, :, 0]
    wy = o[:, None, 1] - position[None, :, 1]
    wz = o[:, None, 2] - position[None, :, 2]
    rox, roy, roz = _rot_apply_t(rb, wx, wy, wz)               # (R, C)
    rdx, rdy, rdz = _rot_apply_t(rb, d[:, None, 0], d[:, None, 1],
                                 d[:, None, 2])
    ro = jnp.stack([rox, roy, roz], axis=-1)
    rd = jnp.stack([rdx, rdy, rdz], axis=-1)

    inv_d = _safe_div(jnp.ones_like(rd), rd)
    ta = (mins[None, :, :] - ro) * inv_d
    tb = (maxs[None, :, :] - ro) * inv_d
    t1 = jnp.minimum(ta, tb)
    t2 = jnp.maximum(ta, tb)
    t_near = jnp.max(t1, axis=-1)
    t_far = jnp.min(t2, axis=-1)

    ok = (t_near < t_far) & (t_far > 0.0) & valid[None, :]
    inside = ok & (t_near < 0.0)
    t = jnp.where(inside, t_far, t_near)
    ok = ok & (t > 0.0)
    t_out = jnp.where(ok, t, INF_T)

    if not with_normals:
        return t_out, None, inside

    # Face selection by exact equality with the winning slab boundary,
    # y-before-z priority exactly as the reference (:699-704).
    boundary = jnp.where(inside[..., None], t2, t1)            # (R, C, 3)
    ts = t[..., None]
    face = jnp.where(ts == boundary[..., 1:2], 1,
                     jnp.where(ts == boundary[..., 2:3], 2, 0))[..., 0]
    one_hot = (face[..., None] == jnp.arange(3)[None, None, :]) \
        .astype(t.dtype)
    # rd on the winning axis via the one-hot (elementwise select-and-sum
    # fuses with the slab math; a per-row take_along_axis is a gather)
    rd_face = jnp.sum(one_hot * rd, axis=-1, keepdims=True)
    sign = jnp.where(rd_face > 0.0, -1.0, 1.0)
    n_local = one_hot * sign
    nwx, nwy, nwz = _rot_apply(rb, n_local[..., 0], n_local[..., 1],
                               n_local[..., 2])
    n = jnp.stack([nwx, nwy, nwz], axis=-1)
    n = jnp.where(ok[..., None], n, 0.0)
    return t_out, n, inside


def sphere_blocked(o, d, center, radius, valid, max_t=1.0):
    """Sqrt- and division-free occlusion predicate: does the ray segment
    o + t*d, t in (0, max_t), intersect the sphere? Decides the reference's
    shadow test (hit with 0 < t < 1 on the unnormalized surface->light
    segment, raytrace_compute.glsl:807-819) from the sign pattern of the
    quadratic f(t) = qa t^2 + qb t + qc alone:

      * qc < 0  (origin inside the sphere): the only positive root is t_far,
        and t_far < max_t  <=>  f(max_t) > 0.
      * qc >= 0 (origin outside): either f crosses zero once in the interval
        (f(max_t) < 0), or both roots lie inside it (disc >= 0 and the vertex
        -qb/2qa is in (0, max_t), i.e. qb < 0 and -qb < 2*qa*max_t).

    Exactly equivalent to the sqrt-based closest-hit shadow test except on
    the measure-zero boundary qc == 0 (ray origin exactly on the sphere
    surface — excluded in practice by the 0.01*n shadow offset, :808).

    o, d: (R, 3); center: (C, 3); radius, valid: (C,). Returns (R, C) bool.
    """
    ocx = o[:, None, 0] - center[None, :, 0]
    ocy = o[:, None, 1] - center[None, :, 1]
    ocz = o[:, None, 2] - center[None, :, 2]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    qa = _dot3(dx, dy, dz, dx, dy, dz)                 # (R, 1)
    qb = 2.0 * _dot3(dx, dy, dz, ocx, ocy, ocz)        # (R, C)
    qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (radius * radius)[None, :]
    f_end = (qa * max_t + qb) * max_t + qc             # f(max_t)

    inside_src = qc < 0.0
    blocked_inside = inside_src & (f_end > 0.0)
    disc_ok = qb * qb >= 4.0 * qa * qc
    vertex_in = (qb < 0.0) & (-qb < 2.0 * qa * max_t)
    blocked_outside = (~inside_src) & ((f_end < 0.0) | (disc_ok & vertex_in))
    return (blocked_inside | blocked_outside) & (qa > _DIV_EPS) & valid[None, :]


def plane_candidates(o, d, normal, offset, valid, with_normals=True):
    """Infinite plane dot(n, x) = offset; double-sided (normal flipped toward
    the incoming ray), never 'inside'. Not in the reference — the analytic
    ground-plane primitive for the benchmark configs."""
    nd = _dot3(d[:, None, 0], d[:, None, 1], d[:, None, 2],
               normal[None, :, 0], normal[None, :, 1], normal[None, :, 2])
    no = _dot3(o[:, None, 0], o[:, None, 1], o[:, None, 2],
               normal[None, :, 0], normal[None, :, 1], normal[None, :, 2])
    t = _safe_div(offset[None, :] - no, nd)
    ok = (jnp.abs(nd) > 1.0e-9) & (t > 0.0) & valid[None, :]
    t_out = jnp.where(ok, t, INF_T)
    inside = jnp.zeros_like(ok)
    if not with_normals:
        return t_out, None, inside
    n_unit = _safe_normalize(normal)[None, :, :]
    n = jnp.where(nd[..., None] > 0.0, -n_unit, n_unit)
    n = jnp.broadcast_to(n, t.shape + (3,))
    n = jnp.where(ok[..., None], n, 0.0)
    return t_out, n, inside


# ---------------------------------------------------------------------------
# Chunked running-minimum closest hit
# ---------------------------------------------------------------------------

def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=fill)


class _Best(NamedTuple):
    t: jnp.ndarray
    n: jnp.ndarray
    inside: jnp.ndarray
    material_id: jnp.ndarray
    obj_id: jnp.ndarray


def _init_best(r, dtype):
    return _Best(
        t=jnp.full((r,), INF_T, dtype),
        n=jnp.zeros((r, 3), dtype),
        inside=jnp.zeros((r,), bool),
        material_id=jnp.zeros((r,), jnp.int32),
        obj_id=jnp.full((r,), -1, jnp.int32),
    )


def _fold_chunk(best, t, n, inside, mat_ids, obj_base, chunk_start):
    """Fold an (R, C) candidate block into the running best. First minimum
    wins ties within the chunk and across chunks (strict <).

    Selection uses dense one-hot reductions instead of argmin +
    take_along_axis: per-row dynamic gathers break fusion; min/where/sum
    fuse with the candidate math."""
    c = t.shape[-1]
    tc = jnp.min(t, axis=-1)                            # (R,)
    iota = jnp.arange(c, dtype=jnp.int32)[None, :]      # (1, C)
    # first index attaining the min (matches the reference's first-wins tie)
    j = jnp.min(jnp.where(t == tc[:, None], iota, c), axis=-1)
    sel = (iota == j[:, None])                          # exact one-hot (R, C)
    self_f = sel.astype(t.dtype)

    nc = jnp.sum(self_f[..., None] * n, axis=-2)        # (R, 3)
    ic = jnp.any(sel & inside, axis=-1)
    mc = jnp.sum(jnp.where(sel, mat_ids[None, :], 0), axis=-1)
    oc = (obj_base + chunk_start + j).astype(jnp.int32)

    upd = tc < best.t
    return _Best(
        t=jnp.where(upd, tc, best.t),
        n=jnp.where(upd[:, None], nc, best.n),
        inside=jnp.where(upd, ic, best.inside),
        material_id=jnp.where(upd, mc.astype(jnp.int32), best.material_id),
        obj_id=jnp.where(upd, oc, best.obj_id),
    )


def _chunk_iter(count, chunk_size):
    nchunks = max(1, -(-count // chunk_size))
    padded = nchunks * chunk_size
    return nchunks, padded


def closest_hit(scene: Scene, origins, dirs, chunk_size: int = 512,
                remat: bool = False) -> Hit:
    """Closest collision over all scene objects (reference
    get_closest_collision, :738-782), as a chunked running minimum.

    origins, dirs: (R, 3). Returns Hit with (R,)-shaped fields.
    """
    r = origins.shape[0]
    dtype = origins.dtype
    best = _init_best(r, dtype)
    maybe_ckpt = jax.checkpoint if remat else (lambda f: f)

    sph: Spheres = scene.spheres
    if sph.count:
        n_obj = sph.count
        nchunks, padded = _chunk_iter(n_obj, min(chunk_size, n_obj))
        csize = padded // nchunks
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        mat = _pad_to(sph.material_id, padded)
        valid = _pad_to(jnp.ones((n_obj,), bool), padded, False)

        @maybe_ckpt
        def sph_chunk(best, c, r, v, m, base):
            t, n, inside = sphere_candidates(origins, dirs, c, r, v)
            return _fold_chunk(best, t, n, inside, m, 0, base)

        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            best = sph_chunk(best, center[sl], radius[sl], valid[sl],
                             mat[sl], s)

    box: Boxes = scene.boxes
    if box.count:
        n_obj = box.count
        nchunks, padded = _chunk_iter(n_obj, min(chunk_size, n_obj))
        csize = padded // nchunks
        rot = euler_rotation_3x3b(box.angles)            # (M, 3, 3)
        mins = _pad_to(box.mins, padded)
        maxs = _pad_to(box.maxs, padded)
        pos = _pad_to(box.position, padded)
        rot = _pad_to(rot, padded)
        mat = _pad_to(box.material_id, padded)
        valid = _pad_to(jnp.ones((n_obj,), bool), padded, False)
        base = sph.count

        @maybe_ckpt
        def box_chunk(best, mn, mx, ps, rt, v, m, cs):
            t, n, inside = box_candidates(origins, dirs, mn, mx, ps, rt, v)
            return _fold_chunk(best, t, n, inside, m, base, cs)

        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            best = box_chunk(best, mins[sl], maxs[sl], pos[sl], rot[sl],
                             valid[sl], mat[sl], s)

    pln: Planes = scene.planes
    if pln.count:
        n_obj = pln.count
        valid = jnp.ones((n_obj,), bool)
        t, n, inside = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                        valid)
        best = _fold_chunk(best, t, n, inside, pln.material_id,
                           sph.count + box.count, 0)

    hit = best.t < MISS_T
    t_for_p = jnp.where(hit, best.t, 0.0)
    p = origins + t_for_p[:, None] * dirs
    return Hit(t=best.t, p=p, n=best.n, inside=best.inside,
               material_id=best.material_id,
               obj_id=jnp.where(hit, best.obj_id, -1), hit=hit)


def closest_hit_sp(scene: Scene, origins, dirs,
                   chunk_size: int = 512) -> Hit:
    """Closest hit for sphere/plane scenes with a normal-free sphere scan.

    Semantically identical to ``closest_hit`` but ~1.5x cheaper per candidate:
    the chunk scan folds only (t, index, inside, material, winning *center*)
    — the winner's normal is reconstructed once per ray at finalize as
    normalize(p - c) with the inside flip, instead of computing and folding a
    unit normal for every (ray, sphere) candidate. Same first-object-wins tie
    semantics (strict <; spheres precede planes in the global index order, so
    a sphere beats a plane at equal t).
    """
    assert scene.boxes.count == 0, "closest_hit_sp: sphere/plane scenes only"
    r = origins.shape[0]
    dtype = origins.dtype

    t_s = jnp.full((r,), INF_T, dtype)
    c_s = jnp.zeros((r, 3), dtype)
    in_s = jnp.zeros((r,), bool)
    mat_s = jnp.zeros((r,), jnp.int32)
    idx_s = jnp.full((r,), -1, jnp.int32)

    sph: Spheres = scene.spheres
    if sph.count:
        n_obj = sph.count
        nchunks, padded = _chunk_iter(n_obj, min(chunk_size, n_obj))
        csize = padded // nchunks
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        mat = _pad_to(sph.material_id, padded)
        valid = _pad_to(jnp.ones((n_obj,), bool), padded, False)

        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            t, _, inside = sphere_candidates(origins, dirs, center[sl],
                                             radius[sl], valid[sl],
                                             with_normals=False)
            c = t.shape[-1]
            tc = jnp.min(t, axis=-1)
            iota = jnp.arange(c, dtype=jnp.int32)[None, :]
            j = jnp.min(jnp.where(t == tc[:, None], iota, c), axis=-1)
            sel = iota == j[:, None]
            # winner-center fold: one-hot matmul, exact at HIGHEST
            cc = jnp.matmul(sel.astype(dtype), center[sl],
                            precision=jax.lax.Precision.HIGHEST)
            ic = jnp.any(sel & inside, axis=-1)
            mc = jnp.sum(jnp.where(sel, mat[sl][None, :], 0), axis=-1)
            upd = tc < t_s
            t_s = jnp.where(upd, tc, t_s)
            c_s = jnp.where(upd[:, None], cc, c_s)
            in_s = jnp.where(upd, ic, in_s)
            mat_s = jnp.where(upd, mc.astype(jnp.int32), mat_s)
            idx_s = jnp.where(upd, (s + j).astype(jnp.int32), idx_s)

    # Finalize sphere normals: n = normalize(p - c), flipped when inside
    hit_s = t_s < MISS_T
    ts = jnp.where(hit_s, t_s, 0.0)
    p_s = origins + ts[:, None] * dirs
    u = p_s - c_s
    inv_len = jax.lax.rsqrt(jnp.maximum(jnp.sum(u * u, axis=-1), _SQRT_EPS))
    sgn = jnp.where(in_s, -inv_len, inv_len) * hit_s.astype(dtype)
    n_s = u * sgn[:, None]

    pln: Planes = scene.planes
    if pln.count:
        valid = jnp.ones((pln.count,), bool)
        t, n, _ = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                   valid)
        bp = _fold_chunk(_init_best(r, dtype), t, n,
                         jnp.zeros_like(t, bool), pln.material_id,
                         sph.count, 0)
        # spheres precede planes: sphere wins ties (strict < kept the first)
        sw = t_s <= bp.t
        t_s = jnp.where(sw, t_s, bp.t)
        n_s = jnp.where(sw[:, None], n_s, bp.n)
        in_s = jnp.where(sw, in_s, bp.inside)
        mat_s = jnp.where(sw, mat_s, bp.material_id)
        idx_s = jnp.where(sw, idx_s, bp.obj_id)

    hit = t_s < MISS_T
    t_for_p = jnp.where(hit, t_s, 0.0)
    p = origins + t_for_p[:, None] * dirs
    return Hit(t=t_s, p=p, n=n_s, inside=in_s & hit, material_id=mat_s,
               obj_id=jnp.where(hit, idx_s, -1), hit=hit)


def shadow_occlusion_sp(scene: Scene, shadow_org, to_lights,
                        chunk_size: int = 512,
                        lights_mask: tuple | None = None) -> jnp.ndarray:
    """All-lights shadow occlusion in ONE scan over the scene.
    shadow_org (R, 3) is shared by every light (p + 0.01*n, :808);
    to_lights is (R, L, 3) unnormalized segments. Returns (R, L) bool.
    Boxes (when present) get a dense per-light slab pass — box counts are
    small in every reference/graded scene.

    Cheaper than L independent ``any_hit`` passes: the origin-to-center
    vectors and the qc term of the occlusion quadratic depend only on the
    shared origin, so each sphere chunk computes them once and reuses them
    for every light's sqrt-free predicate (see ``sphere_blocked``).

    lights_mask: static per-light bools (shading.static_shadow_mask) — False
    lights get no shadow casts and report unoccluded (output-identical for
    ambient-only lights whose occlusion is multiplied by zero anyway).
    """
    r, n_lights = to_lights.shape[0], to_lights.shape[1]
    occ = [jnp.zeros((r,), bool) for _ in range(n_lights)]
    active = [j for j in range(n_lights)
              if lights_mask is None or lights_mask[j]]

    lx = {j: to_lights[:, j, 0:1] for j in active}         # (R, 1) each
    ly = {j: to_lights[:, j, 1:2] for j in active}
    lz = {j: to_lights[:, j, 2:3] for j in active}
    qa = {j: _dot3(lx[j], ly[j], lz[j], lx[j], ly[j], lz[j])
          for j in active}

    sph: Spheres = scene.spheres
    if sph.count:
        n_obj = sph.count
        nchunks, padded = _chunk_iter(n_obj, min(chunk_size, n_obj))
        csize = padded // nchunks
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        valid = _pad_to(jnp.ones((n_obj,), bool), padded, False)

        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            c, rad, v = center[sl], radius[sl], valid[sl]
            ocx = shadow_org[:, None, 0] - c[None, :, 0]   # shared: (R, C)
            ocy = shadow_org[:, None, 1] - c[None, :, 1]
            ocz = shadow_org[:, None, 2] - c[None, :, 2]
            qc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - (rad * rad)[None, :]
            inside_src = qc < 0.0
            for j in active:
                qb = 2.0 * _dot3(lx[j], ly[j], lz[j], ocx, ocy, ocz)
                f_end = qa[j] + qb + qc                    # f(1)
                blocked_in = inside_src & (f_end > 0.0)
                disc_ok = qb * qb >= 4.0 * qa[j] * qc
                vertex_in = (qb < 0.0) & (-qb < 2.0 * qa[j])
                blocked_out = (~inside_src) & ((f_end < 0.0)
                                               | (disc_ok & vertex_in))
                blocked = (blocked_in | blocked_out) & (qa[j] > _DIV_EPS) \
                    & v[None, :]
                occ[j] = occ[j] | jnp.any(blocked, axis=-1)

    box: Boxes = scene.boxes
    if box.count:
        rot = euler_rotation_3x3b(box.angles)           # (M, 3, 3)
        v = jnp.ones((box.count,), bool)
        for j in active:
            t, _, _ = box_candidates(shadow_org, to_lights[:, j, :],
                                     box.mins, box.maxs, box.position, rot,
                                     v, with_normals=False)
            occ[j] = occ[j] | jnp.any(t < 1.0, axis=-1)

    pln: Planes = scene.planes
    if pln.count:
        v = jnp.ones((pln.count,), bool)
        for j in active:
            t, _, _ = plane_candidates(shadow_org, to_lights[:, j, :],
                                       pln.normal, pln.offset, v,
                                       with_normals=False)
            occ[j] = occ[j] | jnp.any(t < 1.0, axis=-1)

    return jnp.stack(occ, axis=-1)


def any_hit(scene: Scene, origins, dirs, max_t: float = 1.0,
            chunk_size: int = 512, remat: bool = False) -> jnp.ndarray:
    """Occlusion query: does any object intersect at 0 < t < max_t?

    Matches the reference's shadow predicate (closest collision with
    ``t < 1.0`` on the *unnormalized* surface->light segment, :807-819):
    since the closest hit rejects t <= 0, 'closest t < 1' is equivalent to
    'exists a hit with t in (0, 1)'. Normals are skipped — this is ~2x
    cheaper than closest_hit.
    """
    r = origins.shape[0]
    occluded = jnp.zeros((r,), bool)
    maybe_ckpt = jax.checkpoint if remat else (lambda f: f)

    def fold(occ, t):
        return occ | jnp.any(t < max_t, axis=-1)   # miss = INF_T > max_t

    sph: Spheres = scene.spheres
    if sph.count:
        n_obj = sph.count
        nchunks, padded = _chunk_iter(n_obj, min(chunk_size, n_obj))
        csize = padded // nchunks
        center = _pad_to(sph.center, padded)
        radius = _pad_to(sph.radius, padded)
        valid = _pad_to(jnp.ones((n_obj,), bool), padded, False)

        @maybe_ckpt
        def sph_chunk(occ, c, r, v):
            blocked = sphere_blocked(origins, dirs, c, r, v, max_t=max_t)
            return occ | jnp.any(blocked, axis=-1)

        for s in range(0, padded, csize):
            sl = slice(s, s + csize)
            occluded = sph_chunk(occluded, center[sl], radius[sl], valid[sl])

    box: Boxes = scene.boxes
    if box.count:
        rot = euler_rotation_3x3b(box.angles)
        valid = jnp.ones((box.count,), bool)
        t, _, _ = box_candidates(origins, dirs, box.mins, box.maxs,
                                 box.position, rot, valid, with_normals=False)
        occluded = fold(occluded, t)

    pln: Planes = scene.planes
    if pln.count:
        valid = jnp.ones((pln.count,), bool)
        t, _, _ = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                   valid, with_normals=False)
        occluded = fold(occluded, t)

    return occluded
