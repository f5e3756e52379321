"""Culled narrow phase as Pallas kernels compiled through Triton.

The reference's hot loop is get_closest_collision's all-objects scan per ray
(raytrace_compute.glsl:738-782) plus one occlusion scan per light (:813).
The pure-XLA culled engine (ops/accel.py) cuts the scan from N objects to
each tile's K broad-phase survivors, but its narrow phase materializes
(tiles, K, pixels) candidate blocks in device memory. This module runs the
SAME broad phase and replaces the narrow phases with kernels shaped like the
reference shader: one program per block of BR rays of a tile, each ray
folding a running closest hit over the tile's survivor rows in registers
and writing only its final hit record.

Pipeline (identical contract to accel.culled_geometry):

  XLA     broad phase: tile cones -> conservative sphere-vs-cone masks ->
          compaction -> survivor parameter rows gathered per tile (T*K
          rows), with per-ray-invariant terms precomputed (oc = o0 - c and
          qc for spheres; the world->local origin for OBBs — primary rays
          share one pinhole origin, so these are per-survivor scalars)
  kernel A  closest hit over (Kp sphere + Kb box + planes) survivor rows;
          grid (tiles, tile_p / BR), each program loops over its tile's
          measured survivor count (a dynamic trip count read from a global
          int32 table) with scalar row loads
  XLA     shadow cones from the hit positions -> per-light survivor lists
  kernel B  per-light occlusion over (Ks sphere + Ksb box + plane) survivor
          rows on the unnormalized surface->light segment; sphere occlusion
          is reported separately so the dense hot-tile pass can override it
          exactly as accel.py does
  XLA     hot-tile override + CullAux assembly (counts/overflow identical)

The narrow-phase arithmetic mirrors accel.py's operation for operation
(which itself mirrors intersect.py and the GLSL :583-724), so images match
the culled engine to float rounding; discrete outputs (winner ids, inside
flags, occlusion bits) come from the same comparisons in the same fold order
(ascending survivor order, first-wins ties, strict-< box merge,
object-beats-plane ties). A compiled kernel may contract the quadratic's
multiply-adds differently from XLA, so on the GPU a ray that grazes a
sphere tangentially can flip its `disc >= 0` test and pick a different
winner that is equally valid at float precision; interpret mode (the CPU
test environment) shares XLA's arithmetic and matches bit-exactly.

Differentiation: ``culled_pallas_geometry_op`` reuses accel.py's
tile-structured analytic VJP verbatim (``accel._culled_bwd``) — the kernels
produce the same (hit, aux) residuals, so engine='culled_pallas' is exactly
as differentiable as engine='culled'.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from openglraytracer_tpu.models.scene import MISS_T, Scene
from openglraytracer_tpu.ops.accel import (
    CullAux,
    _box_table,
    _gather_tile_rows,
    _segment_occluded,
    _sphere_table,
    _dense_compact,
    bounce_cones,
    box_bounding_spheres,
    compact_mask,
    shadow_tile_cones,
    sphere_vs_cone,
    tile_cones,
)
from openglraytracer_tpu.ops.intersect import INF_T, Hit, _DIV_EPS, _SQRT_EPS
from openglraytracer_tpu.ops.shading import SHADOW_EPS

# Rays per program: a power of two (Triton block shapes must be), sized for
# registers — each ray carries a 9-value running minimum through the
# survivor loop, so 256 rays over 4 warps is 2 rays per thread.
BLOCK_RAYS = 256
NUM_WARPS = 4
NUM_STAGES = 1


def interpret_mode(platform: str | None = None) -> bool:
    """How this module's kernels run on `platform` (default: JAX's default
    backend): compiled through Triton on a GPU, in the Pallas interpreter on
    the CPU (the test environment). Any other platform raises — nothing
    falls back silently to the interpreter or to a reference path."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"culled_pallas kernels run on 'gpu' (Triton) or 'cpu' (interpret "
        f"mode), not on '{platform}'")


def ray_block(tile_p: int) -> tuple[int, int]:
    """(BR, padded tile size): BR is BLOCK_RAYS, or the smallest power of
    two holding the whole tile when the tile is smaller; the tile is padded
    up to a multiple of BR (padding rays have zero direction and are
    sliced off the outputs)."""
    br = min(BLOCK_RAYS, pl.next_power_of_2(tile_p))
    return br, pl.cdiv(tile_p, br) * br


def _trip_counts(count, k: int):
    """Rows each tile's survivor loop scans: its true survivor count, capped
    at the list length k. Rows past the count are invalid padding, so any
    trip count in [min(count, k), k] gives the same result."""
    return jnp.minimum(count, k).astype(jnp.int32)


def _triton_call(kernel, name: str, grid, in_specs, out_specs, out_shape,
                 *args):
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, backend="triton", name=name,
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=NUM_STAGES),
        interpret=interpret_mode(),
    )(*args)


def _whole(x):
    """Every program sees the whole (small) array: trip-count tables, the
    plane and light tables, the hot pass's global object tables."""
    return pl.BlockSpec(x.shape, lambda *_: (0,) * x.ndim)


def _per_tile(x):
    """Program (t, s) sees tile t's slice of a (T, ...) array."""
    return pl.BlockSpec((None,) + x.shape[1:],
                        lambda t, s: (t,) + (0,) * (x.ndim - 1))


def _inv_safe(x):
    """Sign-preserving 1/x, |x| clamped away from 0 (intersect._safe_div)."""
    xs = jnp.where(jnp.abs(x) < _DIV_EPS,
                   jnp.where(x < 0, -_DIV_EPS, _DIV_EPS), x)
    return 1.0 / xs


# ---------------------------------------------------------------------------
# Kernel A: primary closest hit over survivor rows
# ---------------------------------------------------------------------------
# sphere row (8):  [ocx ocy ocz qc mat gid valid pad]   oc = o0 - c (scalar
#                  per survivor: pinhole origin), qc = oc.oc - r^2
# box row (24):    [mins(3) maxs(3) ro(3) rot(9) mat gid valid ...] with
#                  ro = R^T (o0 - pos) precomputed
# plane row (16):  [nx ny nz off unx uny unz off-n.o0 mat gid ...]

def _primary_kernel(n_kp: int, n_kb: int, n_pln: int, per_ray: bool,
                    cnt_ref, sph_ref, box_ref, pln_ref, *refs):
    """cnt_ref (T, 2) int32: per tile [sphere trips, box trips] — at most
    the list length, 0 for tiles another pass handles. Rows past the count
    are never read; rows before it are the ascending survivor list."""
    if per_ray:
        # secondary rays have no shared pinhole: survivor rows carry raw
        # geometry and the origin-relative terms are per-ray vector math
        (dx_ref, dy_ref, dz_ref, ox_ref, oy_ref, oz_ref,
         t_ref, nx_ref, ny_ref, nz_ref,
         ins_ref, mat_ref, gid_ref, slot_ref) = refs
        ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    else:
        (dx_ref, dy_ref, dz_ref,
         t_ref, nx_ref, ny_ref, nz_ref,
         ins_ref, mat_ref, gid_ref, slot_ref) = refs
    ti = pl.program_id(0)
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    f32 = dx.dtype

    qa = dx * dx + dy * dy + dz * dz
    qa_ok = qa > _DIV_EPS
    inv_2qa = 0.5 / jnp.where(qa < _DIV_EPS, _DIV_EPS, qa)  # _safe_div, qa>=0

    inf = jnp.full_like(dx, INF_T)
    zero = jnp.zeros_like(dx)

    def sphere_best(j, carry):
        tb, nx, ny, nz, ins, flp, mat, gid, slot = carry
        if per_ray:
            # row: [cx cy cz r2 mat gid valid pad]
            ocx = ox - sph_ref[j, 0]
            ocy = oy - sph_ref[j, 1]
            ocz = oz - sph_ref[j, 2]
            qc = ocx * ocx + ocy * ocy + ocz * ocz - sph_ref[j, 3]
        else:
            # row: [ocx ocy ocz qc mat gid valid pad] (pinhole-precomputed)
            ocx = sph_ref[j, 0]
            ocy = sph_ref[j, 1]
            ocz = sph_ref[j, 2]
            qc = sph_ref[j, 3]
        qb = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
        qd = qb * qb - 4.0 * qa * qc
        ok = (qd >= 0.0) & qa_ok & (sph_ref[j, 6] > 0.5)
        sq = jnp.where(ok, jnp.sqrt(jnp.maximum(qd, _SQRT_EPS)), 0.0)
        t1 = (-qb + sq) * inv_2qa
        t2 = (-qb - sq) * inv_2qa
        t_near = jnp.minimum(t1, t2)
        t_far = jnp.maximum(t1, t2)
        ok = ok & (t_far >= 0.0)
        is_in = ok & (t_near < 0.0)
        t = jnp.where(is_in, t_far, t_near)
        ok = ok & (t > 0.0)
        t = jnp.where(ok, t, inf)
        upd = t < tb
        in_f = is_in.astype(f32)
        jf = j.astype(f32)
        return (jnp.where(upd, t, tb),
                jnp.where(upd, ocx + t * dx, nx),   # u = (o0-c) + t d = p - c
                jnp.where(upd, ocy + t * dy, ny),
                jnp.where(upd, ocz + t * dz, nz),
                jnp.where(upd, in_f, ins),
                jnp.where(upd, in_f, flp),
                jnp.where(upd, sph_ref[j, 4], mat),
                jnp.where(upd, sph_ref[j, 5], gid),
                jnp.where(upd, jf, slot))

    carry = (inf, zero, zero, zero, zero, zero, zero,
             jnp.full_like(dx, -1.0), zero)
    if n_kp:
        carry = jax.lax.fori_loop(0, cnt_ref[ti, 0], sphere_best, carry)

    def box_best(j, carry):
        tb, nx, ny, nz, ins, flp, mat, gid, slot = carry
        bm0, bm1, bm2 = box_ref[j, 0], box_ref[j, 1], box_ref[j, 2]
        bx0, bx1, bx2 = box_ref[j, 3], box_ref[j, 4], box_ref[j, 5]
        r00, r01, r02 = box_ref[j, 9], box_ref[j, 10], box_ref[j, 11]
        r10, r11, r12 = box_ref[j, 12], box_ref[j, 13], box_ref[j, 14]
        r20, r21, r22 = box_ref[j, 15], box_ref[j, 16], box_ref[j, 17]
        if per_ray:
            # slots 6:9 hold the box POSITION; world->local origin per ray:
            # ro = R^T (o - pos)
            wx = ox - box_ref[j, 6]
            wy = oy - box_ref[j, 7]
            wz = oz - box_ref[j, 8]
            rox = r00 * wx + r10 * wy + r20 * wz
            roy = r01 * wx + r11 * wy + r21 * wz
            roz = r02 * wx + r12 * wy + r22 * wz
        else:
            # slots 6:9 hold ro = R^T (o0 - pos), precomputed per survivor
            rox, roy, roz = box_ref[j, 6], box_ref[j, 7], box_ref[j, 8]
        # world -> local direction: R^T d
        rdx = r00 * dx + r10 * dy + r20 * dz
        rdy = r01 * dx + r11 * dy + r21 * dz
        rdz = r02 * dx + r12 * dy + r22 * dz
        ix, iy, iz = _inv_safe(rdx), _inv_safe(rdy), _inv_safe(rdz)
        tax, tbx = (bm0 - rox) * ix, (bx0 - rox) * ix
        tay, tby = (bm1 - roy) * iy, (bx1 - roy) * iy
        taz, tbz = (bm2 - roz) * iz, (bx2 - roz) * iz
        t1x, t2x = jnp.minimum(tax, tbx), jnp.maximum(tax, tbx)
        t1y, t2y = jnp.minimum(tay, tby), jnp.maximum(tay, tby)
        t1z, t2z = jnp.minimum(taz, tbz), jnp.maximum(taz, tbz)
        t_near = jnp.maximum(t1x, jnp.maximum(t1y, t1z))
        t_far = jnp.minimum(t2x, jnp.minimum(t2y, t2z))
        ok = (t_near < t_far) & (t_far > 0.0) & (box_ref[j, 20] > 0.5)
        is_in = ok & (t_near < 0.0)
        t = jnp.where(is_in, t_far, t_near)
        ok = ok & (t > 0.0)
        t = jnp.where(ok, t, inf)
        upd = t < tb
        # face pick: exact equality with the winning slab boundary,
        # y-before-z priority (accel._box_narrow / reference :699-708)
        by = jnp.where(is_in, t2y, t1y)
        bz = jnp.where(is_in, t2z, t1z)
        face_y = t == by
        face_z = (~face_y) & (t == bz)
        face_x = ~(face_y | face_z)
        rd_face = jnp.where(face_y, rdy, jnp.where(face_z, rdz, rdx))
        sgn = jnp.where(rd_face > 0.0, -1.0, 1.0)
        nlx = jnp.where(face_x, sgn, 0.0)
        nly = jnp.where(face_y, sgn, 0.0)
        nlz = jnp.where(face_z, sgn, 0.0)
        nwx = r00 * nlx + r01 * nly + r02 * nlz
        nwy = r10 * nlx + r11 * nly + r12 * nlz
        nwz = r20 * nlx + r21 * nly + r22 * nlz
        jf = j.astype(f32)
        return (jnp.where(upd, t, tb),
                jnp.where(upd, nwx, nx),
                jnp.where(upd, nwy, ny),
                jnp.where(upd, nwz, nz),
                jnp.where(upd, is_in.astype(f32), ins),
                jnp.where(upd, 0.0, flp),
                jnp.where(upd, box_ref[j, 18], mat),
                jnp.where(upd, box_ref[j, 19], gid),
                jnp.where(upd, jf, slot))

    if n_kb:
        carry = jax.lax.fori_loop(0, cnt_ref[ti, 1], box_best, carry)

    tb, nx, ny, nz, ins, flp, mat, gid, slot = carry
    for p in range(n_pln):
        pnx, pny, pnz = pln_ref[p, 0], pln_ref[p, 1], pln_ref[p, 2]
        off_no = pln_ref[p, 7]      # off - n.o0 (per-ray mode: just off)
        if per_ray:
            off_no = off_no - (pnx * ox + pny * oy + pnz * oz)
        nd = pnx * dx + pny * dy + pnz * dz
        t = off_no * _inv_safe(nd)
        ok = (jnp.abs(nd) > 1.0e-9) & (t > 0.0)
        t = jnp.where(ok, t, inf)
        upd = t < tb          # strict: objects beat planes at equal t
        s = jnp.where(nd > 0.0, -1.0, 1.0)
        tb = jnp.where(upd, t, tb)
        nx = jnp.where(upd, pln_ref[p, 4] * s, nx)
        ny = jnp.where(upd, pln_ref[p, 5] * s, ny)
        nz = jnp.where(upd, pln_ref[p, 6] * s, nz)
        ins = jnp.where(upd, 0.0, ins)
        flp = jnp.where(upd, 0.0, flp)
        mat = jnp.where(upd, pln_ref[p, 8], mat)
        gid = jnp.where(upd, pln_ref[p, 9], gid)
        slot = jnp.where(upd, -1.0, slot)

    hit_f = (tb < MISS_T).astype(f32)
    inv_len = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz,
                                        _SQRT_EPS))
    sgn = jnp.where(flp > 0.5, -inv_len, inv_len) * hit_f
    t_ref[...] = tb
    nx_ref[...] = nx * sgn
    ny_ref[...] = ny * sgn
    nz_ref[...] = nz * sgn
    ins_ref[...] = ins
    mat_ref[...] = mat
    gid_ref[...] = gid
    slot_ref[...] = slot


# ---------------------------------------------------------------------------
# Kernel B: per-light shadow occlusion over survivor rows
# ---------------------------------------------------------------------------
# sphere shadow row (8):  [cx cy cz r valid ...]
# box shadow row (24):    [mins(3) maxs(3) pos(3) rot(9) valid ...]
# occlusion semantics mirror accel._segment_occluded / _box_segment_occluded:
# the cast origin is the offset shadow origin, the segment is light - p.

def _shadow_kernel(n_lights: int, light_on: tuple, n_ks: int, n_ksb: int,
                   n_pln: int, cnt_ref, lg_ref, ssph_ref, sbox_ref, pln_ref,
                   sx_ref, sy_ref, sz_ref, px_ref, py_ref, pz_ref,
                   occ_s_ref, occ_o_ref):
    """cnt_ref (T, L, 2) int32: per (tile, light) [sphere trips (0 for hot
    tiles — the dense pass overrides their sphere occlusion), box trips]."""
    ti = pl.program_id(0)
    sx, sy, sz = sx_ref[...], sy_ref[...], sz_ref[...]
    px, py, pz = px_ref[...], py_ref[...], pz_ref[...]
    f32 = sx.dtype
    zero = jnp.zeros_like(sx)

    for li in range(n_lights):
        if not light_on[li]:
            occ_s_ref[li, :] = zero
            occ_o_ref[li, :] = zero
            continue
        tlx = lg_ref[li, 0] - px
        tly = lg_ref[li, 1] - py
        tlz = lg_ref[li, 2] - pz
        qa = tlx * tlx + tly * tly + tlz * tlz
        qa_ok = qa > _DIV_EPS

        def shadow_sphere(j, occ):
            socx = sx - ssph_ref[li, j, 0]
            socy = sy - ssph_ref[li, j, 1]
            socz = sz - ssph_ref[li, j, 2]
            r = ssph_ref[li, j, 3]
            qb = 2.0 * (tlx * socx + tly * socy + tlz * socz)
            qcs = socx * socx + socy * socy + socz * socz - r * r
            f_end = qa + qb + qcs
            inside_src = qcs < 0.0
            blocked_in = inside_src & (f_end > 0.0)
            disc_ok = qb * qb >= 4.0 * qa * qcs
            vertex_in = (qb < 0.0) & (-qb < 2.0 * qa)
            blocked = jnp.where(inside_src, blocked_in,
                                (f_end < 0.0) | (disc_ok & vertex_in))
            blocked = blocked & qa_ok & (ssph_ref[li, j, 4] > 0.5)
            return jnp.maximum(occ, blocked.astype(f32))

        occ_s = zero
        if n_ks:
            occ_s = jax.lax.fori_loop(0, cnt_ref[ti, li, 0], shadow_sphere,
                                      zero)

        def shadow_box(j, occ):
            bm0, bm1, bm2 = (sbox_ref[li, j, 0], sbox_ref[li, j, 1],
                             sbox_ref[li, j, 2])
            bx0, bx1, bx2 = (sbox_ref[li, j, 3], sbox_ref[li, j, 4],
                             sbox_ref[li, j, 5])
            r00, r01, r02 = (sbox_ref[li, j, 9], sbox_ref[li, j, 10],
                             sbox_ref[li, j, 11])
            r10, r11, r12 = (sbox_ref[li, j, 12], sbox_ref[li, j, 13],
                             sbox_ref[li, j, 14])
            r20, r21, r22 = (sbox_ref[li, j, 15], sbox_ref[li, j, 16],
                             sbox_ref[li, j, 17])
            wx = sx - sbox_ref[li, j, 6]
            wy = sy - sbox_ref[li, j, 7]
            wz = sz - sbox_ref[li, j, 8]
            rox = r00 * wx + r10 * wy + r20 * wz
            roy = r01 * wx + r11 * wy + r21 * wz
            roz = r02 * wx + r12 * wy + r22 * wz
            rdx = r00 * tlx + r10 * tly + r20 * tlz
            rdy = r01 * tlx + r11 * tly + r21 * tlz
            rdz = r02 * tlx + r12 * tly + r22 * tlz
            ix, iy, iz = _inv_safe(rdx), _inv_safe(rdy), _inv_safe(rdz)
            tax, tbx = (bm0 - rox) * ix, (bx0 - rox) * ix
            tay, tby = (bm1 - roy) * iy, (bx1 - roy) * iy
            taz, tbz = (bm2 - roz) * iz, (bx2 - roz) * iz
            t1 = jnp.maximum(jnp.minimum(tax, tbx),
                             jnp.maximum(jnp.minimum(tay, tby),
                                         jnp.minimum(taz, tbz)))
            t2 = jnp.minimum(jnp.maximum(tax, tbx),
                             jnp.minimum(jnp.maximum(tay, tby),
                                         jnp.maximum(taz, tbz)))
            ok = (t1 < t2) & (t2 > 0.0) & (sbox_ref[li, j, 18] > 0.5)
            t = jnp.where(ok & (t1 < 0.0), t2, t1)
            blocked = ok & (t > 0.0) & (t < 1.0)
            return jnp.maximum(occ, blocked.astype(f32))

        occ_o = zero
        if n_ksb:
            occ_o = jax.lax.fori_loop(0, cnt_ref[ti, li, 1], shadow_box, zero)

        for p in range(n_pln):
            pnx, pny, pnz = pln_ref[p, 0], pln_ref[p, 1], pln_ref[p, 2]
            nd = pnx * tlx + pny * tly + pnz * tlz
            no = pnx * sx + pny * sy + pnz * sz
            t = (pln_ref[p, 3] - no) * _inv_safe(nd)
            blocked = (jnp.abs(nd) > 1.0e-9) & (t > 0.0) & (t < 1.0)
            occ_o = jnp.maximum(occ_o, blocked.astype(f32))

        occ_s_ref[li, :] = occ_s
        occ_o_ref[li, :] = occ_o


# ---------------------------------------------------------------------------
# Row packing (XLA, tiny)
# ---------------------------------------------------------------------------

def _pad_cols(x, width: int):
    return jnp.pad(x, ((0, 0), (0, 0), (0, width - x.shape[-1])))


def _primary_sphere_rows(scene: Scene, o0, p_idx, p_valid):
    """(T, Kp, 8) kernel rows from the survivor lists: oc, qc precomputed."""
    rows = _gather_tile_rows(_sphere_table(scene), p_idx)   # (T, Kp, 6)
    oc = o0[None, None, :] - rows[..., 0:3]
    qc = jnp.sum(oc * oc, axis=-1) - rows[..., 3] * rows[..., 3]
    return jnp.concatenate([
        oc, qc[..., None], rows[..., 4:6],
        p_valid.astype(rows.dtype)[..., None],
        jnp.zeros_like(qc)[..., None]], axis=-1)


def _primary_box_rows(scene: Scene, o0, b_idx, b_valid):
    """(T, Kb, 24) kernel rows: mins/maxs, local-space origin, rot, ids."""
    rows = _gather_tile_rows(_box_table(scene), b_idx)      # (T, Kb, 20)
    w = o0[None, None, :] - rows[..., 6:9]                  # o0 - pos
    rot = rows[..., 9:18].reshape(rows.shape[:2] + (3, 3))
    ro = jnp.einsum("tkij,tki->tkj", rot, w,                # R^T w
                    precision=jax.lax.Precision.HIGHEST)
    out = jnp.concatenate([
        rows[..., 0:6], ro, rows[..., 9:18], rows[..., 18:20],
        b_valid.astype(rows.dtype)[..., None]], axis=-1)    # (T, Kb, 21)
    return _pad_cols(out, 24)


def _secondary_sphere_rows(scene: Scene, p_idx, p_valid):
    """(T, Kp, 8) [cx cy cz r^2 mat gid valid pad] — raw geometry for the
    per-ray-origin kernel (no shared pinhole to precompute oc/qc against)."""
    rows = _gather_tile_rows(_sphere_table(scene), p_idx)   # (T, Kp, 6)
    r2 = rows[..., 3] * rows[..., 3]
    return jnp.concatenate([
        rows[..., 0:3], r2[..., None], rows[..., 4:6],
        p_valid.astype(rows.dtype)[..., None],
        jnp.zeros_like(r2)[..., None]], axis=-1)


def _secondary_box_rows(scene: Scene, b_idx, b_valid):
    """(T, Kb, 24) [mins maxs pos rot9 mat gid valid ...] — box POSITION in
    slots 6:9 (the per-ray kernel computes R^T (o - pos) itself)."""
    rows = _gather_tile_rows(_box_table(scene), b_idx)      # (T, Kb, 20)
    out = jnp.concatenate([rows,
                           b_valid.astype(rows.dtype)[..., None]], axis=-1)
    return _pad_cols(out, 24)


def _plane_table(scene: Scene, o0, n_sph: int, n_box: int):
    """(P, 16) [n(3) off un(3) off-n.o0 mat gid ...]; raw normal for the
    candidate t (bit-matching accel's plane_candidates), unit for the
    output normal."""
    pln = scene.planes
    p = pln.count
    dtype = pln.normal.dtype if p else jnp.float32
    tab = jnp.zeros((max(p, 1), 16), dtype)
    if p:
        nrm = pln.normal
        length = jnp.sqrt(jnp.maximum(
            jnp.sum(nrm * nrm, axis=-1, keepdims=True), _SQRT_EPS))
        no = jnp.sum(nrm * o0[None, :], axis=-1)
        tab = tab.at[:, 0:3].set(nrm)
        tab = tab.at[:, 3].set(pln.offset)
        tab = tab.at[:, 4:7].set(nrm / length)
        tab = tab.at[:, 7].set(pln.offset - no)
        tab = tab.at[:, 8].set(pln.material_id.astype(dtype))
        tab = tab.at[:, 9].set(n_sph + n_box
                               + jnp.arange(p, dtype=dtype))
    return tab


def _shadow_sphere_rows(scene: Scene, s_idx, s_valid):
    """(T, Ks, 8) [c(3) r valid ...]."""
    tab = jnp.concatenate([scene.spheres.center,
                           scene.spheres.radius[:, None]], axis=-1)
    rows = _gather_tile_rows(tab, s_idx)                    # (T, Ks, 4)
    out = jnp.concatenate([rows, s_valid.astype(rows.dtype)[..., None]],
                          axis=-1)
    return _pad_cols(out, 8)


def _shadow_box_rows(scene: Scene, sb_idx, sb_valid):
    """(T, Ksb, 24) [mins maxs pos rot9 valid ...]."""
    rows = _gather_tile_rows(_box_table(scene), sb_idx)     # (T, Ksb, 20)
    out = jnp.concatenate([rows[..., 0:18],
                           sb_valid.astype(rows.dtype)[..., None]], axis=-1)
    return _pad_cols(out, 24)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ray_components(x, t_tiles: int, tile_p: int, tile_pad: int):
    """(R, 3) tile-major -> three (T, tile_pad) component arrays, each tile
    zero-padded from tile_p to tile_pad rays."""
    comps = x.reshape(t_tiles, tile_p, 3)
    if tile_pad != tile_p:
        comps = jnp.pad(comps, ((0, 0), (0, tile_pad - tile_p), (0, 0)))
    return comps[..., 0], comps[..., 1], comps[..., 2]


def culled_geometry_pallas(scene: Scene, origins, dirs, tile_p: int, kp: int,
                           ks: int, shadow_lights: tuple | None = None,
                           hot_m: int = 0, kb: int = 0, ksb: int = 0,
                           active=None, hot_p: int = 0):
    """accel.culled_geometry with the narrow phases as Triton kernels.

    Same arguments, same return contract: (Hit (R,), occluded (R, L),
    CullAux). Any tile size works: each tile's rays are split into
    ray_block(tile_p) programs, padded up to a multiple of BR.

    active (R,) bool switches on SECONDARY-RAY mode exactly as in
    accel.culled_geometry: per-ray origins, bounce-cone broad phase
    (origin-bbox apex + Minkowski-expanded spheres), inactive rays forced
    to miss. The kernels run in per_ray mode — survivor rows carry raw
    geometry and the origin-relative terms are computed per ray.

    hot_p > 0 (secondary mode only): HOT-PRIMARY tiles. Bounce-cone
    survivor counts are heavy-tailed on curved-mirror scenes (a tile
    looking at a sphere's surface reflects across the whole scene), so
    sizing the static (T, Kp, 8) row gather by the maximum count is
    wasteful. With hot_p, Kp is a quantile cap; the top-hot_p tiles whose
    true count exceeds it skip the gathered lists and run a dense pass over
    the GLOBAL object table (one (N, 8) array that every hot program reads
    through the L2 cache, no gather), which is EXACT (scans every object).
    Their per-tile survivor lists are then rebuilt as ascending
    DISTINCT-WINNER lists so culled_material_rows and the analytic backward
    work unchanged; a hot tile reports overflow only if its winners exceed
    Kp (information the backward would lose — never silent, the same
    contract as cold overflow)."""
    assert hot_p == 0 or active is not None, \
        "hot_p is a secondary-mode (bounce bundle) feature"
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    br, tile_pad = ray_block(tile_p)
    grid = (t_tiles, tile_pad // br)
    dtype = origins.dtype
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    n_pln = scene.planes.count
    n_lights = scene.lights.count
    o0 = origins[0]
    shared = active is None
    kb = min(kb, n_box) if kb > 0 else n_box
    ksb = min(ksb, n_box) if ksb > 0 else n_box
    hot_on = (not shared) and hot_p > 0 and (n_sph > 0 or n_box > 0)

    dirs_t = dirs.reshape(t_tiles, tile_p, 3)
    if shared:
        axis, cos_half = tile_cones(dirs_t)
        apex, expand, empty_t = o0, None, None
    else:
        # secondary bundles: bbox apex + Minkowski expansion + direction
        # cone over ACTIVE rays (accel.culled_geometry's exact recipe —
        # zero-dir TIR rays excluded so they can't blow the cone open)
        origins_t = origins.reshape(t_tiles, tile_p, 3)
        act = active & (jnp.sum(dirs * dirs, -1) > _DIV_EPS)
        act_t = act.reshape(t_tiles, tile_p)
        apex, axis, cos_half, expand, empty_t = bounce_cones(
            origins_t, dirs_t, act_t)

    # ---- broad phase (identical to accel.culled_geometry: dense per-tile
    # compaction — exact)
    if n_sph:
        if shared:
            p_idx, p_valid, p_count = _dense_compact(
                apex, axis, cos_half, scene.spheres.center,
                scene.spheres.radius, kp)
            sph_rows = _primary_sphere_rows(scene, o0, p_idx, p_valid)
        else:
            pmask = sphere_vs_cone(apex, axis, cos_half, scene.spheres.center,
                                   scene.spheres.radius, expand=expand)
            pmask = pmask & (~empty_t)[:, None]
            p_idx, p_valid, p_count = compact_mask(pmask, kp)
            sph_rows = _secondary_sphere_rows(scene, p_idx, p_valid)
    else:
        p_idx = jnp.zeros((t_tiles, 0), jnp.int32)
        p_valid = jnp.zeros((t_tiles, 0), bool)
        p_count = jnp.zeros((t_tiles,), jnp.int32)
        sph_rows = jnp.zeros((t_tiles, 1, 8), dtype)
    kp_eff = p_idx.shape[-1]

    if n_box:
        bc_bs, br_bs = box_bounding_spheres(scene)
        if shared:
            b_idx, b_valid, b_count = _dense_compact(apex, axis, cos_half,
                                                     bc_bs, br_bs, kb)
            box_rows = _primary_box_rows(scene, o0, b_idx, b_valid)
        else:
            bmask = sphere_vs_cone(apex, axis, cos_half, bc_bs, br_bs,
                                   expand=expand)
            bmask = bmask & (~empty_t)[:, None]
            b_idx, b_valid, b_count = compact_mask(bmask, kb)
            box_rows = _secondary_box_rows(scene, b_idx, b_valid)
    else:
        b_idx = jnp.zeros((t_tiles, 0), jnp.int32)
        b_valid = jnp.zeros((t_tiles, 0), bool)
        b_count = jnp.zeros((t_tiles,), jnp.int32)
        box_rows = jnp.zeros((t_tiles, 1, 24), dtype)
    kb_eff = b_idx.shape[-1]

    pln_tab = _plane_table(scene, o0 if shared else jnp.zeros_like(o0),
                           n_sph, n_box)

    rays = _ray_components(dirs, t_tiles, tile_p, tile_pad)
    if not shared:
        rays = rays + _ray_components(origins, t_tiles, tile_p, tile_pad)

    # ---- hot-primary tile selection (secondary mode): tiles whose bounce
    # cone kept more objects than the static caps take the dense
    # global-table pass below; the cold kernel skips them (trip count 0)
    if hot_on:
        hp_m = min(hot_p, t_tiles)
        over = jnp.zeros((t_tiles,), bool)
        score = jnp.zeros((t_tiles,), jnp.int32)
        if n_sph:
            over = over | (p_count > kp_eff)
            score = score + p_count
        if n_box and kb_eff < n_box:
            over = over | (b_count > kb_eff)
        if n_box:
            score = score + b_count
        _, hotp_ids = jax.lax.top_k(jnp.where(over, score, -1), hp_m)
        hotp_real = jnp.take(over, hotp_ids)                  # (M,)
        is_hotp = jnp.zeros((t_tiles,), bool).at[hotp_ids].set(hotp_real)

    # ---- kernel A: primary narrow phase
    cnt_a = jnp.stack([_trip_counts(p_count, kp_eff),
                       _trip_counts(b_count, kb_eff)], axis=-1)  # (T, 2)
    if hot_on:
        cnt_a = jnp.where(is_hotp[:, None], 0, cnt_a)
    ray_spec = pl.BlockSpec((None, br), lambda t, s: (t, s))
    rblk = jax.ShapeDtypeStruct((t_tiles, tile_pad), dtype)
    outs = _triton_call(
        functools.partial(_primary_kernel, kp_eff, kb_eff, n_pln,
                          not shared),
        "culled_primary", grid,
        [_whole(cnt_a), _per_tile(sph_rows), _per_tile(box_rows),
         _whole(pln_tab)] + [ray_spec] * len(rays),
        [ray_spec] * 8, [rblk] * 8,
        cnt_a, sph_rows, box_rows, pln_tab, *rays)

    # ---- hot-primary dense pass: the same per-ray kernel over the GLOBAL
    # object tables (one whole-array operand, read through L2, no gather),
    # trip count = N on the truly-hot tiles, 0 on the top-k slack. EXACT:
    # every object scanned.
    if hot_on:
        if n_sph:
            g_sph = _secondary_sphere_rows(
                scene, jnp.arange(n_sph, dtype=jnp.int32)[None, :],
                jnp.ones((1, n_sph), bool))[0]
        else:
            g_sph = jnp.zeros((1, 8), dtype)
        if n_box:
            g_box = _secondary_box_rows(
                scene, jnp.arange(n_box, dtype=jnp.int32)[None, :],
                jnp.ones((1, n_box), bool))[0]
        else:
            g_box = jnp.zeros((1, 24), dtype)
        cnt_h = jnp.stack(
            [jnp.where(hotp_real, n_sph, 0),
             jnp.where(hotp_real, n_box, 0)],
            axis=-1).astype(jnp.int32)                        # (M, 2)
        hot_in = tuple(jnp.take(x, hotp_ids, axis=0) for x in rays)
        hblk = jax.ShapeDtypeStruct((hp_m, tile_pad), dtype)
        outs_h = _triton_call(
            functools.partial(_primary_kernel, n_sph, n_box, n_pln, True),
            "culled_hot_primary", (hp_m, grid[1]),
            [_whole(cnt_h), _whole(g_sph), _whole(g_box), _whole(pln_tab)]
            + [ray_spec] * 6,
            [ray_spec] * 8, [hblk] * 8,
            cnt_h, g_sph, g_box, pln_tab, *hot_in)

        def hmerge(x_full, x_hot):
            cur = jnp.take(x_full, hotp_ids, axis=0)
            return x_full.at[hotp_ids].set(
                jnp.where(hotp_real[:, None], x_hot, cur))

        outs = tuple(hmerge(xf, xh) for xf, xh in zip(outs, outs_h))

    t_flat, nx_f, ny_f, nz_f, ins_f, mat_f, gid_f, slot_f = (
        x[:, :tile_p].reshape(-1) for x in outs)
    n = jnp.stack([nx_f, ny_f, nz_f], axis=-1)
    if not shared:
        # inactive secondary rays are defined misses (their colors carry
        # zero bounce weight; forcing the miss keeps their garbage out of
        # the shadow-cone bboxes below) — accel.culled_geometry semantics
        t_flat = jnp.where(active, t_flat, INF_T)
    hit_mask = t_flat < MISS_T
    in_flat = (ins_f > 0.5) & hit_mask
    mat_flat = jnp.where(hit_mask, mat_f.astype(jnp.int32), 0)
    gid_flat = jnp.where(hit_mask, gid_f.astype(jnp.int32), -1)
    slot_flat = slot_f.reshape(t_tiles, tile_p).astype(jnp.int32)

    is_sph_w = hit_mask & (gid_flat >= 0) & (gid_flat < n_sph)
    is_box_w = hit_mask & (gid_flat >= n_sph) & (gid_flat < n_sph + n_box)
    j_local = jnp.where(is_sph_w.reshape(t_tiles, tile_p), slot_flat, -1)
    jb_local = jnp.where(is_box_w.reshape(t_tiles, tile_p), slot_flat, -1)

    # ---- posthoc winner lists for hot tiles: the dense pass reports
    # GLOBAL row ids in gid/slot; rebuild ascending distinct-winner lists
    # (idx/valid/count capped at Kp/Kb — overflow = winners the backward
    # would lose, surfaced through the count contract) and re-rank
    # j_local/jb_local into them, so culled_material_rows and _culled_bwd
    # consume hot tiles exactly like cold ones.
    if hot_on:
        gid_t = gid_flat.reshape(t_tiles, tile_p)
        hitm_h = jnp.take(hit_mask.reshape(t_tiles, tile_p), hotp_ids,
                          axis=0) & hotp_real[:, None]
        gid_h = jnp.take(gid_t, hotp_ids, axis=0)            # (M, P)
        ii = jnp.arange(hp_m, dtype=jnp.int32)[:, None]

        def splice(full, hot_rows):
            cur = jnp.take(full, hotp_ids, axis=0)
            sel = hotp_real.reshape((hp_m,) + (1,) * (cur.ndim - 1))
            return full.at[hotp_ids].set(jnp.where(sel, hot_rows, cur))

        def winner_lists(lo, n_obj, k_eff):
            win = hitm_h & (gid_h >= lo) & (gid_h < lo + n_obj)
            loc = jnp.clip(gid_h - lo, 0, n_obj - 1)
            wm = jnp.zeros((hp_m, n_obj), jnp.int32).at[ii, loc].max(
                win.astype(jnp.int32)) > 0
            w_idx, w_valid, w_cnt = compact_mask(wm, k_eff)
            pref = jnp.cumsum(wm.astype(jnp.int32), axis=1)
            rank = jnp.take_along_axis(pref, loc, axis=1) - 1
            # winner-overflow ranks (>= k_eff) fall off the list: mark -1
            # ("not this list's winner") — the tile's count > k flags it
            jl = jnp.where(win & (rank < k_eff), rank, -1)
            return w_idx, w_valid, w_cnt, jl

        if n_sph:
            w_idx, w_valid, w_cnt, jl_h = winner_lists(0, n_sph, kp_eff)
            p_idx = splice(p_idx, w_idx)
            p_valid = splice(p_valid, w_valid)
            p_count = splice(p_count, w_cnt)
            j_local = splice(j_local, jl_h)
        if n_box:
            wb_idx, wb_valid, wb_cnt, jb_h = winner_lists(n_sph, n_box,
                                                          kb_eff)
            b_idx = splice(b_idx, wb_idx)
            b_valid = splice(b_valid, wb_valid)
            b_count = splice(b_count, wb_cnt)
            jb_local = splice(jb_local, jb_h)

    t_for_p = jnp.where(hit_mask, t_flat, 0.0)
    p = origins + t_for_p[:, None] * dirs
    hit = Hit(t=t_flat, p=p, n=n, inside=in_flat,
              material_id=mat_flat, obj_id=gid_flat, hit=hit_mask)

    # ---- shadow broad phase per light (identical to accel) + kernel B
    shadow_org = hit.p + hit.n * SHADOW_EPS
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    p_t = hit.p.reshape(t_tiles, tile_p, 3)

    light_on = tuple(
        (shadow_lights is None or shadow_lights[li]) for li in
        range(n_lights))
    s_counts = []
    s_overflow = []
    sb_counts = []
    sb_overflow = []
    ssph_rows = []   # per light (T, Ks, 8)
    sbox_rows = []   # per light (T, Ksb, 24)
    hot_infos = []   # per light (is_hot (T,), occ_full (T, P)) or None
    zero_c = jnp.zeros((t_tiles,), jnp.int32)
    zero_o = jnp.zeros((), jnp.int32)
    ks_eff = min(ks, n_sph) if n_sph else 0
    ksb_eff = ksb if n_box else 0
    if n_box:
        bc_bs, br_bs = box_bounding_spheres(scene)
    for li in range(n_lights):
        if not light_on[li]:
            s_counts.append(zero_c)
            s_overflow.append(zero_o)
            sb_counts.append(zero_c)
            sb_overflow.append(zero_o)
            ssph_rows.append(jnp.zeros((t_tiles, max(ks_eff, 1), 8), dtype))
            sbox_rows.append(jnp.zeros((t_tiles, max(ksb_eff, 1), 24), dtype))
            hot_infos.append(None)
            continue
        lpos = scene.lights.position[li]
        axis_s, cos_s, max_d, empty_s = shadow_tile_cones(
            shadow_org, hit_mask, tile_p, lpos)
        if n_sph:
            s_idx, s_valid, s_count = _dense_compact(
                lpos, axis_s, cos_s, scene.spheres.center,
                scene.spheres.radius, ks, max_dist=max_d,
                tile_valid=~empty_s)
            s_counts.append(s_count)
            ssph_rows.append(_shadow_sphere_rows(scene, s_idx, s_valid))
            if hot_m > 0:
                _, hot_ids = jax.lax.top_k(s_count, hot_m)
                occ_h = _segment_occluded(
                    jnp.take(so_t, hot_ids, axis=0),
                    jnp.take(p_t, hot_ids, axis=0), lpos,
                    scene.spheres.center[None, :, 0],
                    scene.spheres.center[None, :, 1],
                    scene.spheres.center[None, :, 2],
                    scene.spheres.radius[None, :],
                    jnp.ones((1, n_sph), bool))              # (M, P)
                is_hot = jnp.zeros((t_tiles,), bool).at[hot_ids].set(True)
                occ_full = jnp.zeros((t_tiles, tile_p), bool) \
                    .at[hot_ids].set(occ_h)
                hot_infos.append((is_hot, occ_full))
                s_overflow.append(jnp.sum((s_count > ks) & ~is_hot,
                                          dtype=jnp.int32))
            else:
                hot_infos.append(None)
                s_overflow.append(jnp.sum(s_count > ks, dtype=jnp.int32))
        else:
            s_counts.append(zero_c)
            s_overflow.append(zero_o)
            ssph_rows.append(jnp.zeros((t_tiles, max(ks_eff, 1), 8), dtype))
            hot_infos.append(None)
        if n_box:
            sb_idx, sb_valid, sb_cnt = _dense_compact(
                lpos, axis_s, cos_s, bc_bs, br_bs, ksb, max_dist=max_d,
                tile_valid=~empty_s)
            sbox_rows.append(_shadow_box_rows(scene, sb_idx, sb_valid))
            sb_counts.append(sb_cnt)
            sb_overflow.append(jnp.sum(sb_cnt > ksb, dtype=jnp.int32))
        else:
            sbox_rows.append(jnp.zeros((t_tiles, max(ksb_eff, 1), 24), dtype))
            sb_counts.append(zero_c)
            sb_overflow.append(zero_o)

    if n_lights and any(light_on):
        ssph = jnp.stack(ssph_rows, axis=1)        # (T, L, Ks, 8)
        sbox = jnp.stack(sbox_rows, axis=1)        # (T, L, Ksb, 24)
        cols = []
        for li in range(n_lights):
            sc = _trip_counts(s_counts[li], ssph.shape[2])
            if hot_infos[li] is not None:
                # hot tiles' sphere occlusion is overridden by the dense
                # XLA pass — skip their kernel scan entirely
                sc = jnp.where(hot_infos[li][0], 0, sc)
            cols.append(jnp.stack(
                [sc, _trip_counts(sb_counts[li], sbox.shape[2])], axis=-1))
        cnt_b = jnp.stack(cols, axis=1)                      # (T, L, 2)
        lg = jnp.zeros((n_lights, 8), dtype).at[:, :3].set(
            scene.lights.position)
        seg = (_ray_components(shadow_org, t_tiles, tile_p, tile_pad)
               + _ray_components(hit.p, t_tiles, tile_p, tile_pad))

        occ_spec = pl.BlockSpec((None, n_lights, br), lambda t, s: (t, 0, s))
        occ_shape = jax.ShapeDtypeStruct((t_tiles, n_lights, tile_pad), dtype)
        occ_s, occ_o = _triton_call(
            functools.partial(_shadow_kernel, n_lights, light_on,
                              ssph.shape[2] if n_sph else 0,
                              sbox.shape[2] if n_box else 0, n_pln),
            "culled_shadow", grid,
            [_whole(cnt_b), _whole(lg), _per_tile(ssph), _per_tile(sbox),
             _whole(pln_tab)] + [ray_spec] * 6,
            [occ_spec] * 2, [occ_shape] * 2,
            cnt_b, lg, ssph, sbox, pln_tab, *seg)

        occ_s = occ_s[..., :tile_p] > 0.5
        occ_o = occ_o[..., :tile_p] > 0.5
        occ_cols = []
        for li in range(n_lights):
            col_s = occ_s[:, li]
            if hot_infos[li] is not None:
                is_hot, occ_full = hot_infos[li]
                col_s = jnp.where(is_hot[:, None], occ_full, col_s)
            occ_cols.append((col_s | occ_o[:, li]).reshape(-1))
        occluded = jnp.stack(occ_cols, axis=-1)
    else:
        occluded = jnp.zeros((r_total, n_lights), bool)

    stack_or = lambda xs, shape: (jnp.stack(xs) if n_lights
                                  else jnp.zeros(shape, jnp.int32))
    aux = CullAux(p_idx=p_idx, p_valid=p_valid, p_count=p_count,
                  s_count=stack_or(s_counts, (0, t_tiles)),
                  s_overflow=stack_or(s_overflow, (0,)),
                  j_local=j_local,
                  b_idx=b_idx, b_valid=b_valid, b_count=b_count,
                  sb_count=stack_or(sb_counts, (0, t_tiles)),
                  sb_overflow=stack_or(sb_overflow, (0,)),
                  jb_local=jb_local)
    return hit, occluded, aux


# ---------------------------------------------------------------------------
# Custom VJP: accel.py's tile-structured analytic backward, reused verbatim
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8, 9))
def culled_pallas_geometry_op(scene: Scene, origins, dirs, tile_p: int,
                              kp: int, ks: int,
                              shadow_lights: tuple | None = None,
                              hot_m: int = 0, kb: int = 0, ksb: int = 0):
    return culled_geometry_pallas(scene, origins, dirs, tile_p, kp, ks,
                                  shadow_lights, hot_m, kb, ksb)


def _cp_fwd(scene, origins, dirs, tile_p, kp, ks, shadow_lights, hot_m,
            kb, ksb):
    hit, occ, aux = culled_geometry_pallas(scene, origins, dirs, tile_p, kp,
                                           ks, shadow_lights, hot_m, kb, ksb)
    return (hit, occ, aux), (scene, origins, dirs, hit, aux)


def _cp_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb, res, g):
    from openglraytracer_tpu.ops.accel import _culled_bwd
    return _culled_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb, res, g)


culled_pallas_geometry_op.defvjp(_cp_fwd, _cp_bwd)


@functools.partial(jax.custom_vjp,
                   nondiff_argnums=(4, 5, 6, 7, 8, 9, 10, 11))
def bounce_culled_pallas_geometry_op(scene: Scene, origins, dirs, active,
                                     tile_p: int, kp: int, ks: int,
                                     shadow_lights: tuple | None = None,
                                     hot_m: int = 0, kb: int = 0,
                                     ksb: int = 0, hot_p: int = 0):
    """culled_geometry_pallas in SECONDARY-RAY mode with the same analytic
    VJP as accel.bounce_culled_geometry_op (the backward replays per-ray
    and never assumed a pinhole — reused verbatim, exactly as the primary
    pallas op reuses _culled_bwd). hot_p > 0 adds the dense global-table
    pass for over-cap tiles (see culled_geometry_pallas); the posthoc
    winner lists keep the shared backward exact on hot tiles too."""
    return culled_geometry_pallas(scene, origins, dirs, tile_p, kp, ks,
                                  shadow_lights, hot_m, kb, ksb,
                                  active=active, hot_p=hot_p)


def _bcp_fwd(scene, origins, dirs, active, tile_p, kp, ks, shadow_lights,
             hot_m, kb, ksb, hot_p):
    hit, occ, aux = culled_geometry_pallas(scene, origins, dirs, tile_p, kp,
                                           ks, shadow_lights, hot_m, kb, ksb,
                                           active=active, hot_p=hot_p)
    return (hit, occ, aux), (scene, origins, dirs, hit, aux, active.shape)


def _bcp_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb, hot_p, res, g):
    from openglraytracer_tpu.ops.accel import _bounce_culled_bwd
    return _bounce_culled_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb,
                              res, g)


bounce_culled_pallas_geometry_op.defvjp(_bcp_fwd, _bcp_bwd)
