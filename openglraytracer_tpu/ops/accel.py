"""Broad-phase acceleration: tile-cone culling for primary and shadow rays.

The reference tests every ray against every object (get_closest_collision's
linear scan, raytrace_compute.glsl:738-782 — "no BVH/acceleration structure",
SURVEY.md C18). That is O(rays x objects): fine for 5 objects, hopeless for
the 4096-sphere benchmark config. A classic GPU raytracer would hang a BVH
here; this module instead uses a *dense tile-cone broad phase* with static
shapes throughout (dense arrays that XLA compiles without data-dependent
control flow; a device-built BVH is an open item):

  1. Partition the image into pixel tiles. All primary rays in a tile share
     the camera origin and span a narrow cone: axis = mean direction,
     cos(half-angle) = min over the tile of dot(axis, dir).
  2. Conservatively test every sphere against every tile cone (O(tiles x N),
     ~1000x smaller than rays x N) — a sphere survives iff
     angle(axis, c - apex) <= half_angle + asin(r / |c - apex|), evaluated
     sqrt-wise without any trig.
  3. Compact each tile's survivor set to a static top-K index list
     (compact_mask — survivors keep ascending object order, preserving the
     reference's first-object-wins tie semantics), gather their parameters,
     and run the exact narrow-phase scan only on rays x K.
  4. Shadow rays get the same treatment per light: the cone apex is the light
     position and the cone must contain the tile's bounding box of shadow-ray
     origins (computed on device from the primary hits).
  5. Oriented boxes cull through their bounding spheres (center =
     position + R*(mins+maxs)/2, radius = |maxs-mins|/2 — conservative for
     any rotation) and get their own survivor lists (Kb primary, Ksb shadow);
     the box narrow phase mirrors intersect.box_candidates' slab test
     op-for-op over (tiles, Kb, pixels).

Culling is *conservative*: a surviving superset never changes the image. The
one approximation is the static K: a tile whose true survivor count exceeds K
drops its farthest-indexed objects. The per-tile counts are returned so
callers can size K (``suggest_cull_sizes``) and tests can assert no overflow;
rendering with an overflowing K is a documented, observable approximation —
never a silent default (K is required, no magic fallback).

The backward pass is a custom VJP like ops/geometry.py's but tile-structured:
the winner-parameter gather and the gradient scatter-add go through the
(tiles, K) survivor lists — two tiny one-hot contractions — instead of
(rays -> N) global gathers/scatters, which removes the O(N) factor from the
backward for large scenes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openglraytracer_tpu.models.scene import MISS_T, Scene
from openglraytracer_tpu.ops.intersect import (
    INF_T,
    _DIV_EPS,
    _SQRT_EPS,
    Hit,
    _fold_chunk,
    _init_best,
    _safe_div,
    plane_candidates,
)
from openglraytracer_tpu.ops.shading import SHADOW_EPS

_BBOX_MARGIN = 1.0e-3  # fp slack when bounding shadow origins


# ---------------------------------------------------------------------------
# Image <-> tile layout
# ---------------------------------------------------------------------------

def tile_image(x, th: int, tw: int):
    """(H, W, C) -> (T, P, C) tile-major, P = th*tw. H % th == W % tw == 0."""
    h, w, c = x.shape
    assert h % th == 0 and w % tw == 0, "tile must divide the image"
    return (x.reshape(h // th, th, w // tw, tw, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape((h // th) * (w // tw), th * tw, c))


def untile_image(y, height: int, width: int, th: int, tw: int):
    """Inverse of tile_image for flat (T*P, C) data -> (H, W, C)."""
    c = y.shape[-1]
    return (y.reshape(height // th, width // tw, th, tw, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(height, width, c))


# ---------------------------------------------------------------------------
# Cones and the conservative sphere-vs-cone test
# ---------------------------------------------------------------------------

def tile_cones(dirs):
    """dirs (T, P, 3) unit -> (axis (T, 3), cos_half (T,))."""
    s = jnp.sum(dirs, axis=1)
    axis = s * jax.lax.rsqrt(jnp.maximum(jnp.sum(s * s, -1, keepdims=True),
                                         _SQRT_EPS))
    cos_half = jnp.min(jnp.sum(axis[:, None, :] * dirs, -1), axis=1)
    return axis, jnp.clip(cos_half, -1.0, 1.0)


def sphere_vs_cone(apex, axis, cos_half, centers, radii, max_dist=None,
                   expand=None):
    """Conservative overlap of spheres with per-tile cones.

    apex (T, 3) or (3,); axis (T, 3); cos_half (T,); centers (N, 3);
    radii (N,); optional max_dist (T,) range prune (occluder center within
    max_dist + r of the apex). Returns (T, N) bool.

    The test angle(axis, v) <= half + asin(r/|v|) is evaluated as
    cos(angle) >= cos(half)*cos(asin) - sin(half)*sin(asin) with
    sin(asin) = r/|v|, all sqrt/arith — no trig. A cone with
    cos_half <= 0 (half-angle >= 90 deg: spherically non-convex) keeps
    everything, staying conservative.

    expand (T,): per-tile Minkowski expansion of every sphere's radius —
    used by secondary-ray bundles whose origins span a bbox rather than a
    point (a ray from any point of a box B hits S iff the ray from B's
    center hits S dilated by B's half-diagonal).
    """
    apex = jnp.atleast_2d(apex)                          # (T or 1, 3)
    vx = centers[None, :, 0] - apex[:, 0:1]              # (T, N)
    vy = centers[None, :, 1] - apex[:, 1:2]
    vz = centers[None, :, 2] - apex[:, 2:3]
    d2 = vx * vx + vy * vy + vz * vz
    inv_d = jax.lax.rsqrt(jnp.maximum(d2, _SQRT_EPS))
    ca = (axis[:, 0:1] * vx + axis[:, 1:2] * vy + axis[:, 2:3] * vz) * inv_d

    r_eff = radii[None, :] if expand is None \
        else radii[None, :] + expand[:, None]            # (T-or-1, N)
    inside = d2 <= r_eff * r_eff                         # apex inside sphere
    sin_r = jnp.minimum(r_eff * inv_d, 1.0)
    cos_r = jnp.sqrt(jnp.maximum(1.0 - sin_r * sin_r, 0.0))
    ch = cos_half[:, None]
    sh = jnp.sqrt(jnp.maximum(1.0 - ch * ch, 0.0))
    keep = ca >= ch * cos_r - sh * sin_r
    keep = keep | inside | (ch <= 0.0)
    if max_dist is not None:
        keep = keep & (jnp.sqrt(d2) - r_eff <= max_dist[:, None])
    return keep


def bounce_cones(origins_t, dirs_t, active_t):
    """Conservative per-tile cone for a SECONDARY-ray bundle (reflection /
    refraction children of a culled trace, VERDICT r2 next #4): unlike
    primary rays there is no shared apex, so the bundle is bounded by the
    bbox of its active origins (apex = bbox center, Minkowski expansion
    rho = bbox half-diagonal) plus a direction cone over the active rays.

    origins_t, dirs_t: (T, P, 3); active_t: (T, P) — rays that can
    contribute (parent hit with a positive branch weight AND a nonzero
    direction; TIR refract() yields the zero vector, which misses
    everything in the narrow phase and must not poison the cone).

    Returns (apex (T, 3), axis (T, 3), cos_half (T,), rho (T,),
    empty (T,)). Tiles with no active ray are `empty` (keep nothing).
    """
    dtype = origins_t.dtype
    big = jnp.asarray(INF_T, dtype)
    am = active_t[..., None]
    bmin = jnp.min(jnp.where(am, origins_t, big), axis=1) - _BBOX_MARGIN
    bmax = jnp.max(jnp.where(am, origins_t, -big), axis=1) + _BBOX_MARGIN
    apex = 0.5 * (bmin + bmax)
    rho = 0.5 * jnp.sqrt(jnp.maximum(
        jnp.sum(jnp.square(bmax - bmin), -1), _SQRT_EPS))

    s = jnp.sum(jnp.where(am, dirs_t, 0.0), axis=1)
    axis = s * jax.lax.rsqrt(jnp.maximum(jnp.sum(s * s, -1, keepdims=True),
                                         _SQRT_EPS))
    dots = jnp.sum(axis[:, None, :] * dirs_t, -1)
    cos_half = jnp.min(jnp.where(active_t, dots, 1.0), axis=1)
    empty = ~jnp.any(active_t, axis=1)
    return apex, axis, jnp.clip(cos_half, -1.0, 1.0), rho, empty


def compact_mask(mask, k: int):
    """Dense per-tile compaction of a (T, N) bool mask.

    Returns (idx (T, K) int32 ascending among survivors, valid (T, K) bool,
    count (T,) int32 true survivor totals — count > K means overflow, which
    callers surface, never drop silently). idx is 0 where ~valid.

    Stream compaction by rank: the inclusive prefix count of survivors along
    each row is nondecreasing and steps by one at every survivor, so the
    j-th survivor (1-based) sits at the first column whose prefix count
    reaches j — a binary search per output slot, O(T * K * log N) after one
    O(T * N) prefix sum, and no sort. Inside the c5 frame on the H100 this
    beat lax.top_k and a scatter by rank (scripts/kernel_decisions.py)."""
    n = mask.shape[-1]
    k_eff = min(k, n)
    rank = jnp.cumsum(mask, axis=-1, dtype=jnp.int32)       # (T, N)
    count = rank[:, -1] if n else jnp.zeros(mask.shape[:1], jnp.int32)
    slots = jnp.arange(1, k_eff + 1, dtype=jnp.int32)
    idx = jax.vmap(lambda r: jnp.searchsorted(
        r, slots, side="left", method="scan_unrolled"))(rank)
    valid = slots[None, :] <= count[:, None]
    return jnp.where(valid, idx, 0).astype(jnp.int32), valid, count


# ---------------------------------------------------------------------------
# Two-level (coarse strip -> fine tile) cull compaction — used by no engine
# ---------------------------------------------------------------------------
# The single-level broad phase costs O(T x N) cone tests plus a compaction
# of (T, N) masks. Grouping _COARSE_GROUP consecutive tile-major
# fine tiles into a coarse strip whose cone CONTAINS every member cone
# shrinks both: the coarse level tests (T/G, N), the fine level tests and
# compacts only (T, Kc) coarse survivors. Because the coarse cone is a
# conservative union, an object passing the fine test always passes the
# coarse test — the fine survivor lists are BIT-IDENTICAL to the
# single-level ones (same sets, same ascending order) whenever the coarse
# list did not overflow Kc; a coarse overflow is surfaced through the
# count contract (count forced > k) so it is never silent.

_COARSE_GROUP = 16       # fine tiles per coarse strip
_COARSE_MIN_N = 512      # dense compaction below this object count
# Kc = min(N, max(_COARSE_FACTOR * k, _COARSE_MIN_KC)): the coarse strip
# holds the UNION of 16 member tiles' survivor sets, so its cap needs slack
# beyond the per-tile k — especially under hot-tile sizing, where k is a
# COLD-tile quantile (r4 fit run: 6*k alone overflowed ~50k tile-lists on
# the moving 4096-sphere scene; the floor keeps the coarse level roomy at
# negligible cost — the fine top-k input is still ~N/5 of dense)
_COARSE_FACTOR = 6
_COARSE_MIN_KC = 768


def cone_union(axis_f, cos_f, member_valid=None):
    """Conservative union of member cones sharing an apex.

    axis_f (Tc, G, 3) unit axes, cos_f (Tc, G) cos(half-angle);
    member_valid (Tc, G) — False members are excluded (they keep nothing).
    Returns (axis_c (Tc, 3), cos_c (Tc,)): a cone containing every valid
    member cone: cos_c = min_i cos(angle(axis_c, axis_i) + theta_i),
    evaluated sqrt-wise. Strips whose members are all invalid get
    cos_c = 1 with an arbitrary axis (callers mask them out)."""
    if member_valid is None:
        member_valid = jnp.ones(axis_f.shape[:2], bool)
    mv = member_valid[..., None]
    s = jnp.sum(jnp.where(mv, axis_f, 0.0), axis=1)
    axc = s * jax.lax.rsqrt(jnp.maximum(jnp.sum(s * s, -1, keepdims=True),
                                        _SQRT_EPS))
    ca = jnp.clip(jnp.sum(axc[:, None, :] * axis_f, -1), -1.0, 1.0)
    sa = jnp.sqrt(jnp.maximum(1.0 - ca * ca, 0.0))
    cf = jnp.clip(cos_f, -1.0, 1.0)
    sf = jnp.sqrt(jnp.maximum(1.0 - cf * cf, 0.0))
    # cos(angle_i + theta_i); any member with theta >= 90deg (cf <= 0) keeps
    # everything, so the union must too (the sum formula can miss this when
    # the member axis opposes the union axis)
    expr = jnp.where(member_valid, ca * cf - sa * sf, 1.0)
    cosc = jnp.min(expr, axis=1)
    any_open = jnp.any(member_valid & (cos_f <= 0.0), axis=1)
    cosc = jnp.where(any_open, -1.0, cosc)
    return axc, jnp.clip(cosc, -1.0, 1.0)


def _dense_compact(apex, axis, cos_half, centers, radii, k,
                   max_dist=None, tile_valid=None):
    mask = sphere_vs_cone(apex, axis, cos_half, centers, radii,
                          max_dist=max_dist)
    if tile_valid is not None:
        mask = mask & tile_valid[:, None]
    return compact_mask(mask, k)


def cull_compact(apex, axis, cos_half, centers, radii, k: int,
                 max_dist=None, tile_valid=None, kc: int | None = None):
    """sphere_vs_cone + compact_mask, computed two-level when profitable.

    apex (3,) shared by every tile (pinhole origin or light position);
    axis (T, 3); cos_half (T,); optional max_dist (T,) range prune and
    tile_valid (T,) (False tiles keep nothing). Returns (idx (T, K), valid,
    count) — identical to the dense compact_mask(sphere_vs_cone(...), k)
    result, except that a coarse-level overflow forces count > k (reported,
    never silent).

    kc: coarse strip capacity override. Shadow callers pass a large one —
    a strip near a light legitimately sees far more occluders than any
    member tile (its union cone covers a 16-tile hit bbox), and the r4 fit
    run measured strips overflowing 6*k-sized coarse lists tens of
    thousands of times. kc >= N degrades gracefully to dense."""
    t_tiles = axis.shape[0]
    n = centers.shape[0]
    g = _COARSE_GROUP
    if kc is not None and kc >= n:
        # coarse level would be complete: go dense
        return _dense_compact(apex, axis, cos_half, centers, radii, k,
                              max_dist, tile_valid)
    if n < _COARSE_MIN_N or t_tiles % g or t_tiles // g < 2:
        return _dense_compact(apex, axis, cos_half, centers, radii, k,
                              max_dist, tile_valid)

    tc = t_tiles // g
    mv = (tile_valid.reshape(tc, g) if tile_valid is not None
          else jnp.ones((tc, g), bool))
    axc, cosc = cone_union(axis.reshape(tc, g, 3),
                           cos_half.reshape(tc, g), mv)
    md_c = None
    if max_dist is not None:
        md_c = jnp.max(jnp.where(mv, max_dist.reshape(tc, g),
                                 -jnp.inf), axis=1)
    cmask = sphere_vs_cone(apex, axc, cosc, centers, radii, max_dist=md_c)
    cmask = cmask & jnp.any(mv, axis=1)[:, None]
    if kc is None:
        kc = max(_COARSE_FACTOR * k, _COARSE_MIN_KC)
    kc = min(n, kc)
    c_idx, c_valid, c_count = compact_mask(cmask, kc)       # (Tc, Kc)

    # fine test against the gathered coarse survivors, (Tc, G, Kc) layout
    rows = _gather_tile_rows(
        jnp.concatenate([centers, radii[:, None]], axis=-1), c_idx)
    apex = jnp.asarray(apex)
    vx = rows[..., 0][:, None, :] - apex[0]                 # (Tc, 1->G, Kc)
    vy = rows[..., 1][:, None, :] - apex[1]
    vz = rows[..., 2][:, None, :] - apex[2]
    d2 = vx * vx + vy * vy + vz * vz
    inv_d = jax.lax.rsqrt(jnp.maximum(d2, _SQRT_EPS))
    ax_f = axis.reshape(tc, g, 3)
    ca = (ax_f[..., 0:1] * vx + ax_f[..., 1:2] * vy
          + ax_f[..., 2:3] * vz) * inv_d                    # (Tc, G, Kc)
    r_eff = rows[..., 3][:, None, :]
    inside = d2 <= r_eff * r_eff
    sin_r = jnp.minimum(r_eff * inv_d, 1.0)
    cos_r = jnp.sqrt(jnp.maximum(1.0 - sin_r * sin_r, 0.0))
    ch = cos_half.reshape(tc, g)[..., None]
    sh = jnp.sqrt(jnp.maximum(1.0 - ch * ch, 0.0))
    keep = ca >= ch * cos_r - sh * sin_r
    keep = keep | inside | (ch <= 0.0)
    if max_dist is not None:
        keep = keep & (jnp.sqrt(d2) - r_eff
                       <= max_dist.reshape(tc, g)[..., None])
    keep = keep & c_valid[:, None, :] & mv[..., None]
    fmask = keep.reshape(t_tiles, c_idx.shape[-1])

    f_loc, f_valid, f_count = compact_mask(fmask, k)        # idx into Kc
    c_idx_f = jnp.repeat(c_idx, g, axis=0)                  # (T, Kc)
    idx = jnp.take_along_axis(c_idx_f, f_loc, axis=-1)
    idx = jnp.where(f_valid, idx, 0)
    # coarse overflow => fine counts are lower bounds: force the overflow
    # signal so the never-silent contract holds
    ovf_c = jnp.repeat((c_count > kc) & jnp.any(mv, axis=1), g, axis=0)
    f_count = jnp.where(ovf_c, jnp.maximum(f_count, k + 1), f_count)
    return idx.astype(jnp.int32), f_valid, f_count


# ---------------------------------------------------------------------------
# Culled geometry: forward
# ---------------------------------------------------------------------------

def box_bounding_spheres(scene: Scene):
    """Conservative world-space bounding spheres of the scene's OBBs:
    center = position + R * (mins+maxs)/2, radius = |maxs - mins| / 2.
    Returns (centers (M, 3), radii (M,))."""
    from openglraytracer_tpu.ops.intersect import _rot_apply
    from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b

    b = scene.boxes
    rot = euler_rotation_3x3b(b.angles)                     # (M, 3, 3)
    mid = 0.5 * (b.mins + b.maxs)
    mx, my, mz = _rot_apply(rot, mid[:, 0], mid[:, 1], mid[:, 2])
    centers = b.position + jnp.stack([mx, my, mz], axis=-1)
    radii = 0.5 * jnp.sqrt(jnp.maximum(
        jnp.sum(jnp.square(b.maxs - b.mins), axis=-1), _SQRT_EPS))
    return centers, radii


def shadow_tile_cones(shadow_org, hit_mask, tile_p: int, lpos):
    """Per-tile shadow cone for one light: apex = light, cone contains the
    tile's bounding box of shadow-ray origins, plus the range prune.
    Returns (axis (T, 3), cos_half (T,), max_d (T,), empty (T,)) — empty
    tiles (no hits) keep nothing. Object-independent: computed once per
    light and shared by the sphere and box occluder culls."""
    dtype = shadow_org.dtype
    t_tiles = shadow_org.shape[0] // tile_p
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    hit_t = hit_mask.reshape(t_tiles, tile_p)
    big = jnp.asarray(INF_T, dtype)
    masked = jnp.where(hit_t[..., None], so_t, big)
    bmin = jnp.min(masked, axis=1) - _BBOX_MARGIN          # (T, 3)
    masked = jnp.where(hit_t[..., None], so_t, -big)
    bmax = jnp.max(masked, axis=1) + _BBOX_MARGIN
    empty = ~jnp.any(hit_t, axis=1)                        # (T,)
    # 8 bbox corners (T, 8, 3)
    sel_corner = jnp.asarray(
        [[(c >> a) & 1 for a in range(3)] for c in range(8)], dtype)
    corners = bmin[:, None, :] * (1.0 - sel_corner) \
        + bmax[:, None, :] * sel_corner

    cvec = corners - lpos                                  # (T, 8, 3)
    clen = jnp.sqrt(jnp.maximum(jnp.sum(cvec * cvec, -1), _SQRT_EPS))
    cdir = cvec / clen[..., None]
    axis_s = jnp.sum(cdir, axis=1)
    axis_s = axis_s * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(axis_s * axis_s, -1, keepdims=True), _SQRT_EPS))
    cos_s = jnp.min(jnp.sum(axis_s[:, None, :] * cdir, -1), axis=1)
    max_d = jnp.max(clen, axis=1)
    return axis_s, jnp.clip(cos_s, -1.0, 1.0), max_d, empty


def shadow_cull_mask(scene: Scene, shadow_org, hit_mask, tile_p: int, lpos,
                     centers=None, radii=None):
    """Conservative per-tile occluder mask (T, N) for one light: a cone from
    the light containing the tile's bounding box of shadow-ray origins, plus
    a range prune. Empty tiles (no hits) keep nothing.

    centers/radii default to the scene's spheres; pass box bounding spheres
    to cull OBB occluders."""
    axis_s, cos_s, max_d, empty = shadow_tile_cones(shadow_org, hit_mask,
                                                    tile_p, lpos)
    if centers is None:
        centers, radii = scene.spheres.center, scene.spheres.radius
    smask = sphere_vs_cone(lpos, axis_s, cos_s, centers, radii,
                           max_dist=max_d)
    return smask & (~empty)[:, None]


def _segment_occluded(so_t, p_t, lpos, scx, scy, scz, sr, valid):
    """Sqrt-free shadow-segment occlusion (see intersect.sphere_blocked) for
    batched tiles. so_t, p_t: (B, P, 3) cast origins / hit points; sphere
    params (B, K) or (1, K); valid (B, K) or (1, K). Returns (B, P) bool.

    The segment is light - p (reference :809) while the cast origin is the
    offset so_t — matching the exact path's semantics exactly. Candidates
    are laid out (B, K, P) with pixels on the minor axis (see the narrow-
    phase layout note in culled_geometry)."""
    tlx = (lpos[0] - p_t[..., 0])[:, None, :]              # (B, 1, P)
    tly = (lpos[1] - p_t[..., 1])[:, None, :]
    tlz = (lpos[2] - p_t[..., 2])[:, None, :]
    qa = tlx * tlx + tly * tly + tlz * tlz                 # (B, 1, P)
    socx = so_t[..., 0][:, None, :] - scx[:, :, None]      # (B, K, P)
    socy = so_t[..., 1][:, None, :] - scy[:, :, None]
    socz = so_t[..., 2][:, None, :] - scz[:, :, None]
    qb = 2.0 * (tlx * socx + tly * socy + tlz * socz)
    qcs = socx * socx + socy * socy + socz * socz \
        - (sr * sr)[:, :, None]
    f_end = qa + qb + qcs
    inside_src = qcs < 0.0
    blocked_in = inside_src & (f_end > 0.0)
    disc_ok = qb * qb >= 4.0 * qa * qcs
    vertex_in = (qb < 0.0) & (-qb < 2.0 * qa)
    blocked = jnp.where(inside_src, blocked_in,
                        (f_end < 0.0) | (disc_ok & vertex_in))
    blocked = blocked & (qa > _DIV_EPS) & valid[:, :, None]
    return jnp.any(blocked, axis=1)


def _box_table(scene: Scene):
    """(M, 20) [mins(3) maxs(3) pos(3) rot(9) mat gid] — ids as exact small
    floats; gid is the GLOBAL object index (spheres precede boxes)."""
    from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b

    b = scene.boxes
    m = b.count
    dtype = b.mins.dtype
    rot = euler_rotation_3x3b(b.angles).reshape(m, 9)
    n_sph = scene.spheres.count
    return jnp.concatenate([
        b.mins, b.maxs, b.position, rot,
        b.material_id.astype(dtype)[:, None],
        (n_sph + jnp.arange(m, dtype=dtype))[:, None],
    ], axis=-1)


def _box_slab_tkp(rows, b_valid, rox, roy, roz, rdx, rdy, rdz):
    """Slab test in the (T, K, P) layout given LOCAL-space ray components
    (each (T, K, P) or broadcastable). rows (T, K, >=18) box table rows.
    Mirrors intersect.box_candidates operation-for-operation so candidate
    t's are bit-identical to the exact engine's. Returns (t (miss=INF), ok,
    inside, boundary t1/t2 per axis) — normals are the caller's job."""
    one = jnp.ones_like(rdx)
    ivx = _safe_div(one, rdx)
    ivy = _safe_div(one, rdy)
    ivz = _safe_div(one, rdz)
    tax = (rows[..., 0:1] - rox) * ivx                      # mins - ro
    tay = (rows[..., 1:2] - roy) * ivy
    taz = (rows[..., 2:3] - roz) * ivz
    tbx = (rows[..., 3:4] - rox) * ivx                      # maxs - ro
    tby = (rows[..., 4:5] - roy) * ivy
    tbz = (rows[..., 5:6] - roz) * ivz
    t1x, t2x = jnp.minimum(tax, tbx), jnp.maximum(tax, tbx)
    t1y, t2y = jnp.minimum(tay, tby), jnp.maximum(tay, tby)
    t1z, t2z = jnp.minimum(taz, tbz), jnp.maximum(taz, tbz)
    t_near = jnp.maximum(t1x, jnp.maximum(t1y, t1z))
    t_far = jnp.minimum(t2x, jnp.minimum(t2y, t2z))

    ok = (t_near < t_far) & (t_far > 0.0) & b_valid[..., None]
    inside = ok & (t_near < 0.0)
    t = jnp.where(inside, t_far, t_near)
    ok = ok & (t > 0.0)
    t = jnp.where(ok, t, INF_T)
    return t, ok, inside, (t1x, t1y, t1z, t2x, t2y, t2z)


def _rot_tkp(rows, vx, vy, vz, transpose: bool):
    """Rotate (T, K-or-1, P) vector components by each row's 3x3 (cols 9:18).
    transpose=True applies R^T (world -> local)."""
    r = [rows[..., 9 + i : 10 + i] for i in range(9)]       # (T, K, 1) each
    if transpose:
        return (r[0] * vx + r[3] * vy + r[6] * vz,
                r[1] * vx + r[4] * vy + r[7] * vz,
                r[2] * vx + r[5] * vy + r[8] * vz)
    return (r[0] * vx + r[1] * vy + r[2] * vz,
            r[3] * vx + r[4] * vy + r[5] * vz,
            r[6] * vx + r[7] * vy + r[8] * vz)


def _box_narrow(rows, b_valid, o0, dirs_t, origins_t=None):
    """Primary box narrow phase over tile survivors: shared pinhole origin
    o0 (3,) — or per-ray origins_t (T, P, 3) for secondary-ray bundles —
    dirs_t (T, P, 3). Returns per-candidate (t, ok, inside,
    n (3 components)) in (T, Kb, P) layout, normals oriented exactly as
    intersect.box_candidates (y-before-z face-equality pick, sign from the
    local-space direction)."""
    if origins_t is None:
        wx = (o0[0] - rows[..., 6])[..., None]              # (T, Kb, 1)
        wy = (o0[1] - rows[..., 7])[..., None]
        wz = (o0[2] - rows[..., 8])[..., None]
    else:
        wx = origins_t[..., 0][:, None, :] - rows[..., 6:7]  # (T, Kb, P)
        wy = origins_t[..., 1][:, None, :] - rows[..., 7:8]
        wz = origins_t[..., 2][:, None, :] - rows[..., 8:9]
    rox, roy, roz = _rot_tkp(rows, wx, wy, wz, transpose=True)
    dx = dirs_t[..., 0][:, None, :]                         # (T, 1, P)
    dy = dirs_t[..., 1][:, None, :]
    dz = dirs_t[..., 2][:, None, :]
    rdx, rdy, rdz = _rot_tkp(rows, dx, dy, dz, transpose=True)

    t, ok, inside, bounds = _box_slab_tkp(rows, b_valid, rox, roy, roz,
                                          rdx, rdy, rdz)

    _, t1y, t1z, _, t2y, t2z = bounds
    by = jnp.where(inside, t2y, t1y)
    bz = jnp.where(inside, t2z, t1z)
    face_y = t == by
    face_z = (~face_y) & (t == bz)
    face_x = ~(face_y | face_z)
    rd_face = jnp.where(face_y, rdy, jnp.where(face_z, rdz, rdx))
    sgn = jnp.where(rd_face > 0.0, -1.0, 1.0)
    nlx = jnp.where(face_x, sgn, 0.0)
    nly = jnp.where(face_y, sgn, 0.0)
    nlz = jnp.where(face_z, sgn, 0.0)
    nwx, nwy, nwz = _rot_tkp(rows, nlx, nly, nlz, transpose=False)
    okf = ok.astype(t.dtype)
    return t, ok, inside, (nwx * okf, nwy * okf, nwz * okf)


def _box_segment_occluded(rows, b_valid, so_t, p_t, lpos):
    """Box occlusion on the shadow segment: cast origin so_t (B, P, 3),
    unnormalized direction light - p_t (reference :809). Blocked iff the
    slab hit has t in (0, 1) — identical to the exact engine's
    box_candidates + t < 1 fold. Returns (B, P) bool."""
    wx = so_t[..., 0][:, None, :] - rows[..., 6:7]          # (B, K, P)
    wy = so_t[..., 1][:, None, :] - rows[..., 7:8]
    wz = so_t[..., 2][:, None, :] - rows[..., 8:9]
    rox, roy, roz = _rot_tkp(rows, wx, wy, wz, transpose=True)
    tlx = (lpos[0] - p_t[..., 0])[:, None, :]
    tly = (lpos[1] - p_t[..., 1])[:, None, :]
    tlz = (lpos[2] - p_t[..., 2])[:, None, :]
    rdx, rdy, rdz = _rot_tkp(rows, tlx, tly, tlz, transpose=True)
    t, ok, _, _ = _box_slab_tkp(rows, b_valid, rox, roy, roz, rdx, rdy, rdz)
    return jnp.any(ok & (t < 1.0), axis=1)


class CullAux(NamedTuple):
    """Survivor lists + counts (counts are diagnostics: count > K = overflow)."""
    p_idx: jnp.ndarray      # (T, Kp) primary survivor SPHERE ids
    p_valid: jnp.ndarray    # (T, Kp)
    p_count: jnp.ndarray    # (T,)
    s_count: jnp.ndarray    # (L, T)
    s_overflow: jnp.ndarray  # (L,) cold tiles whose occluders exceeded Ks
    j_local: jnp.ndarray    # (T, P) winning sphere survivor slot (-1 = other)
    b_idx: jnp.ndarray      # (T, Kb) primary survivor BOX ids (local 0..M)
    b_valid: jnp.ndarray    # (T, Kb)
    b_count: jnp.ndarray    # (T,)
    sb_count: jnp.ndarray   # (L, T) shadow box survivor counts
    sb_overflow: jnp.ndarray  # (L,) tiles whose box occluders exceeded Ksb
    jb_local: jnp.ndarray   # (T, P) winning box survivor slot (-1 = other)


def _sphere_table(scene: Scene):
    """(N, 6) [cx cy cz r mat gid] — ids as exact small floats."""
    n = scene.spheres.count
    return jnp.concatenate([
        scene.spheres.center,
        scene.spheres.radius[:, None],
        scene.spheres.material_id.astype(scene.spheres.center.dtype)[:, None],
        jnp.arange(n, dtype=scene.spheres.center.dtype)[:, None],
    ], axis=-1)


def _gather_tile_rows(table, idx):
    """table (N, F), idx (T, K) -> (T, K, F). T*K rows is small (~1e4-1e6)."""
    return jnp.take(table, idx.reshape(-1), axis=0).reshape(
        idx.shape + (table.shape[-1],))


def parse_cull_spec(cull):
    """Normalize a cull spec ``(tile, kp, ks[, hot_m[, kb, ksb]])`` to a
    6-tuple. ``tile`` is (th, tw) at the image level or tile_p once tiled;
    kb/ksb = 0 mean dense boxes (Kb = Ksb = M — trivially complete; box
    counts are tiny in every reference/graded scene)."""
    tile, kp, ks = cull[:3]
    hot_m = cull[3] if len(cull) > 3 else 0
    kb = cull[4] if len(cull) > 4 else 0
    ksb = cull[5] if len(cull) > 5 else 0
    return tile, kp, ks, hot_m, kb, ksb


def cull_hot_p(cull) -> int:
    """Optional 7th spec element: hot-PRIMARY tile count for the secondary
    (bounce-bundle) kernel path. Tiles whose bounce cone keeps more than Kp
    objects are routed to a dense all-objects kernel pass over the global
    object table instead of a gathered per-tile survivor list — Kp can then
    be sized by a quantile of the counts instead of the max (curved-mirror
    tiles legitimately see most of the scene; sizing every tile's static
    list for them means a (T, 4096, 8) gather per bounce level on
    c4_mirror4096). 0 = no hot-primary pass
    (every 6-element spec behaves exactly as before)."""
    return cull[6] if len(cull) > 6 else 0


def culled_geometry(scene: Scene, origins, dirs, tile_p: int, kp: int,
                    ks: int, shadow_lights: tuple | None = None,
                    hot_m: int = 0, kb: int = 0, ksb: int = 0,
                    active=None):
    """Closest hit + all-light occlusion with tile-cone culling.

    origins, dirs: (R, 3) in TILE-MAJOR order (tile_image), R = T * tile_p;
    every origin must be the same point (primary pinhole rays) UNLESS
    ``active`` is given (secondary mode, below). dirs unit.
    shadow_lights: static per-light bools — False skips that light's shadow
    pass (shading.static_shadow_mask). hot_m > 0 gives the top-M
    highest-count tiles per light a dense all-spheres shadow pass so ks can
    be sized by a quantile of the counts instead of the max (long shadows
    make a few tiles legitimately see most of the scene). Oriented boxes
    cull through their bounding spheres into separate (T, Kb) primary and
    (T, Ksb) shadow survivor lists; kb/ksb = 0 (the default) means dense
    (Kb = M). Returns (Hit (R,), occluded (R, L), CullAux).

    active (R,) bool switches on SECONDARY-RAY mode (VERDICT r2 next #4 —
    bounce children previously fell back to the dense O(R*N) scan): origins
    are per-ray (reflection/refraction spawn points), the broad phase uses
    bounce_cones (origin-bbox apex + Minkowski-expanded spheres + a
    direction cone over active rays), and inactive rays — parents that
    missed or have zero branch weight — are forced to MISS (their colors
    are masked to zero by the blend anyway; forcing the miss keeps their
    garbage out of the shadow-cone bboxes).
    """
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    dtype = origins.dtype
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    centers, radii = scene.spheres.center, scene.spheres.radius
    shared = active is None
    o0 = origins[0]
    kb = min(kb, n_box) if kb > 0 else n_box
    ksb = min(ksb, n_box) if ksb > 0 else n_box

    dirs_t = dirs.reshape(t_tiles, tile_p, 3)
    if shared:
        axis, cos_half = tile_cones(dirs_t)
        apex, expand = o0, None
        origins_t = None
    else:
        origins_t = origins.reshape(t_tiles, tile_p, 3)
        # zero-direction rays (TIR refract) miss everything in the narrow
        # phase (qa guard); exclude them from the cone so they can't blow
        # it open to a half-space
        act = active & (jnp.sum(dirs * dirs, -1) > _DIV_EPS)
        act_t = act.reshape(t_tiles, tile_p)
        apex, axis, cos_half, expand, empty_t = bounce_cones(
            origins_t, dirs_t, act_t)

    if n_sph:
        # ---- primary broad phase. NOTE (r4): the two-level coarse-strip
        # compaction (cull_compact) was withdrawn from the engines after the
        # fit's overflow counter showed horizon strips exceeding ANY coarse
        # cap (perspective compresses hundreds of distant objects into one
        # strip's cone) — lossy culling is never acceptable as a default.
        # Dense per-tile compaction is exact; the r4 perf wins that stand
        # are the dynamic trip counts and the fused shade kernel.
        if shared:
            p_idx, p_valid, p_count = _dense_compact(apex, axis, cos_half,
                                                     centers, radii, kp)
        else:
            pmask = sphere_vs_cone(apex, axis, cos_half, centers, radii,
                                   expand=expand)
            pmask = pmask & (~empty_t)[:, None]
            p_idx, p_valid, p_count = compact_mask(pmask, kp)
        kp_eff = p_idx.shape[-1]
        rows = _gather_tile_rows(_sphere_table(scene), p_idx)  # (T, Kp, 6)
        cx, cy, cz = rows[..., 0], rows[..., 1], rows[..., 2]  # (T, Kp)
        rad = rows[..., 3]

        # ---- narrow phase per (tile, survivor, pixel). The arithmetic
        # mirrors intersect.sphere_candidates OPERATION FOR OPERATION so
        # candidate t's are bit-identical to the exact path's — a
        # reformulation (e.g. qa = 1 for unit dirs) rounds differently and
        # flips disc's sign on tangent grazes, visibly changing ~1e-4 of
        # pixels vs the exact engine.
        #
        # LAYOUT: candidates are (T, Kp, P) with PIXELS on the minor
        # (contiguous) axis, so the reductions over Kp below are strided
        # sums over full pixel rows.
        if shared:
            ocx = (o0[0] - cx)[:, :, None]                  # (T, Kp, 1): o-c
            ocy = (o0[1] - cy)[:, :, None]
            ocz = (o0[2] - cz)[:, :, None]
        else:  # per-ray origins: (T, 1, P) - (T, Kp, 1) -> (T, Kp, P)
            ocx = origins_t[..., 0][:, None, :] - cx[:, :, None]
            ocy = origins_t[..., 1][:, None, :] - cy[:, :, None]
            ocz = origins_t[..., 2][:, None, :] - cz[:, :, None]
        qc = (ocx * ocx + ocy * ocy + ocz * ocz
              - (rad * rad)[:, :, None])                    # (T, Kp, 1)
        dx = dirs_t[..., 0][:, None, :]                     # (T, 1, P)
        dy = dirs_t[..., 1][:, None, :]
        dz = dirs_t[..., 2][:, None, :]
        qa = dx * dx + dy * dy + dz * dz                    # (T, 1, P)
        qb = 2.0 * (dx * ocx + dy * ocy + dz * ocz)         # (T, Kp, P)
        qd = qb * qb - 4.0 * qa * qc
        ok = (qd >= 0.0) & (qa > _DIV_EPS) & p_valid[:, :, None]
        sq = jnp.where(ok, jnp.sqrt(jnp.maximum(qd, _SQRT_EPS)), 0.0)
        inv_2qa = _safe_div(jnp.asarray(0.5, dtype), qa)
        t1 = (-qb + sq) * inv_2qa
        t2 = (-qb - sq) * inv_2qa
        t_near = jnp.minimum(t1, t2)
        t_far = jnp.maximum(t1, t2)
        ok = ok & (t_far >= 0.0)
        inside = ok & (t_near < 0.0)
        t = jnp.where(inside, t_far, t_near)
        ok = ok & (t > 0.0)
        t = jnp.where(ok, t, INF_T)

        # ---- fold winner: min-t + first-survivor tie (ascending order)
        tc = jnp.min(t, axis=1)                             # (T, P)
        iota = jnp.arange(kp_eff, dtype=jnp.int32)[None, :, None]
        j = jnp.min(jnp.where(t == tc[:, None, :], iota, kp_eff), axis=1)
        sel = iota == j[:, None, :]                         # (T, Kp, P)
        # one batched one-hot contraction folds c/r/mat/gid of the winner
        win = jnp.einsum("tkp,tkf->tfp", sel.astype(dtype), rows,
                         precision=jax.lax.Precision.HIGHEST)  # (T, 6, P)
        ic = jnp.any(sel & inside, axis=1)

        hit_s = tc < MISS_T
        t_flat = tc.reshape(-1)
        in_flat = ic.reshape(-1)
        mat_flat = win[:, 4, :].reshape(-1).astype(jnp.int32)
        gid_flat = win[:, 5, :].reshape(-1).astype(jnp.int32)
        j_local = jnp.where(hit_s, j, -1)

        # finalize sphere normal from the winning center (closest_hit_sp)
        hs_flat = hit_s.reshape(-1)
        ts = jnp.where(hs_flat, t_flat, 0.0)
        p = origins + ts[:, None] * dirs
        u = p - jnp.stack([win[:, 0, :].reshape(-1),
                           win[:, 1, :].reshape(-1),
                           win[:, 2, :].reshape(-1)], axis=-1)
        inv_len = jax.lax.rsqrt(jnp.maximum(jnp.sum(u * u, -1), _SQRT_EPS))
        sgn = jnp.where(in_flat, -inv_len, inv_len) * hs_flat.astype(dtype)
        n = u * sgn[:, None]
    else:
        t_flat = jnp.full((r_total,), INF_T, dtype)
        n = jnp.zeros((r_total, 3), dtype)
        in_flat = jnp.zeros((r_total,), bool)
        mat_flat = jnp.zeros((r_total,), jnp.int32)
        gid_flat = jnp.full((r_total,), -1, jnp.int32)
        j_local = jnp.full((t_tiles, tile_p), -1, jnp.int32)
        p_idx = jnp.zeros((t_tiles, 0), jnp.int32)
        p_valid = jnp.zeros((t_tiles, 0), bool)
        p_count = jnp.zeros((t_tiles,), jnp.int32)

    # ---- boxes: bounding-sphere broad phase + slab narrow phase, merged
    # with the sphere winner in global-id order (spheres precede boxes, so
    # strict < keeps the sphere at equal t — exactly the exact fold's
    # cross-chunk semantics)
    if n_box:
        btab = _box_table(scene)
        bc_bs, br_bs = box_bounding_spheres(scene)
        if shared:
            b_idx, b_valid, b_count = _dense_compact(apex, axis, cos_half,
                                                     bc_bs, br_bs, kb)
        else:
            bmask = sphere_vs_cone(apex, axis, cos_half, bc_bs, br_bs,
                                   expand=expand)
            bmask = bmask & (~empty_t)[:, None]
            b_idx, b_valid, b_count = compact_mask(bmask, kb)
        kb_eff = b_idx.shape[-1]
        brows = _gather_tile_rows(btab, b_idx)              # (T, Kb, 20)
        tb, okb, insb, (nbx, nby, nbz) = _box_narrow(brows, b_valid, o0,
                                                     dirs_t,
                                                     origins_t=origins_t)
        tbc = jnp.min(tb, axis=1)                           # (T, P)
        iota_b = jnp.arange(kb_eff, dtype=jnp.int32)[None, :, None]
        jb = jnp.min(jnp.where(tb == tbc[:, None, :], iota_b, kb_eff),
                     axis=1)
        selb = iota_b == jb[:, None, :]                     # (T, Kb, P)
        selb_f = selb.astype(dtype)
        winb = jnp.einsum("tkp,tkf->tfp", selb_f, brows[..., 18:20],
                          precision=jax.lax.Precision.HIGHEST)  # (T, 2, P)
        nb = jnp.stack([jnp.sum(selb_f * nbx, axis=1).reshape(-1),
                        jnp.sum(selb_f * nby, axis=1).reshape(-1),
                        jnp.sum(selb_f * nbz, axis=1).reshape(-1)], axis=-1)
        icb = jnp.any(selb & insb, axis=1).reshape(-1)
        tb_flat = tbc.reshape(-1)
        use_box = tb_flat < t_flat
        ub_t = use_box.reshape(t_tiles, tile_p)
        t_flat = jnp.where(use_box, tb_flat, t_flat)
        n = jnp.where(use_box[:, None], nb, n)
        in_flat = jnp.where(use_box, icb, in_flat)
        mat_flat = jnp.where(use_box,
                             winb[:, 0, :].reshape(-1).astype(jnp.int32),
                             mat_flat)
        gid_flat = jnp.where(use_box,
                             winb[:, 1, :].reshape(-1).astype(jnp.int32),
                             gid_flat)
        j_local = jnp.where(ub_t, -1, j_local)
        jb_local = jnp.where(ub_t & (tbc < MISS_T), jb, -1)
    else:
        b_idx = jnp.zeros((t_tiles, 0), jnp.int32)
        b_valid = jnp.zeros((t_tiles, 0), bool)
        b_count = jnp.zeros((t_tiles,), jnp.int32)
        jb_local = jnp.full((t_tiles, tile_p), -1, jnp.int32)

    # ---- planes: dense (tiny count), merged with object-first tie order
    pln = scene.planes
    if pln.count:
        tpl, npl, _ = plane_candidates(origins, dirs, pln.normal, pln.offset,
                                       jnp.ones((pln.count,), bool))
        bp = _fold_chunk(_init_best(r_total, dtype), tpl, npl,
                         jnp.zeros_like(tpl, bool), pln.material_id,
                         n_sph + n_box, 0)
        sw = t_flat <= bp.t
        t_flat = jnp.where(sw, t_flat, bp.t)
        n = jnp.where(sw[:, None], n, bp.n)
        in_flat = jnp.where(sw, in_flat, bp.inside)
        mat_flat = jnp.where(sw, mat_flat, bp.material_id)
        gid_flat = jnp.where(sw, gid_flat, bp.obj_id)
        sw_t = sw.reshape(t_tiles, tile_p)
        j_local = jnp.where(sw_t, j_local, -1)
        jb_local = jnp.where(sw_t, jb_local, -1)

    if not shared:
        # inactive secondary rays are defined misses: their colors carry
        # zero weight in the bounce blend, and masking here keeps their
        # (arbitrary) hit points out of the shadow-cone bboxes below
        t_flat = jnp.where(active, t_flat, INF_T)
        act_full = active.reshape(t_tiles, tile_p)
        j_local = jnp.where(act_full, j_local, -1)
        jb_local = jnp.where(act_full, jb_local, -1)

    hit_mask = t_flat < MISS_T
    t_for_p = jnp.where(hit_mask, t_flat, 0.0)
    p = origins + t_for_p[:, None] * dirs
    hit = Hit(t=t_flat, p=p, n=n, inside=in_flat & hit_mask,
              material_id=jnp.where(hit_mask, mat_flat, 0),
              obj_id=jnp.where(hit_mask, gid_flat, -1), hit=hit_mask)

    # ---- shadows: per-light cone from the light over the tile's hit bbox
    shadow_org = hit.p + hit.n * SHADOW_EPS
    so_t = shadow_org.reshape(t_tiles, tile_p, 3)
    p_t = hit.p.reshape(t_tiles, tile_p, 3)

    n_lights = scene.lights.count
    occ_cols = []
    s_counts = []
    s_overflow = []
    sb_counts = []
    sb_overflow = []
    zero_c = jnp.zeros((t_tiles,), jnp.int32)
    zero_o = jnp.zeros((), jnp.int32)
    for li in range(n_lights):
        if shadow_lights is not None and not shadow_lights[li]:
            occ_cols.append(jnp.zeros((r_total,), bool))
            s_counts.append(zero_c)
            s_overflow.append(zero_o)
            sb_counts.append(zero_c)
            sb_overflow.append(zero_o)
            continue
        lpos = scene.lights.position[li]
        occ_t = jnp.zeros((t_tiles, tile_p), bool)
        axis_s, cos_s, max_d, empty_s = shadow_tile_cones(
            shadow_org, hit_mask, tile_p, lpos)

        if n_sph:
            # shadows compact DENSELY: a strip near a light can
            # legitimately see almost every object (its union cone spans a
            # 16-tile hit bbox), so no coarse cap short of N is lossless —
            # the r4 fit measured strips exceeding even 12*K caps. Dense
            # per-tile counts are exact; primaries keep the two-level win
            # (camera cones are tight: c5 max 46 survivors vs the 768 cap).
            s_idx, s_valid, s_count = _dense_compact(
                lpos, axis_s, cos_s, centers, radii, ks, max_dist=max_d,
                tile_valid=~empty_s)
            s_counts.append(s_count)
            srows = _gather_tile_rows(
                jnp.concatenate([centers, radii[:, None]], -1), s_idx)
            occ_t = _segment_occluded(so_t, p_t, lpos,
                                      srows[..., 0], srows[..., 1],
                                      srows[..., 2], srows[..., 3],
                                      s_valid)               # (T, P)

            if hot_m > 0:
                # hot-tile pass: the top-M tiles by potential-occluder count
                # get a dense all-spheres test, so the static Ks only has to
                # cover the OTHER tiles — sized by a quantile, not the max.
                _, hot_ids = jax.lax.top_k(s_count, hot_m)
                occ_h = _segment_occluded(
                    jnp.take(so_t, hot_ids, axis=0),
                    jnp.take(p_t, hot_ids, axis=0), lpos,
                    centers[None, :, 0], centers[None, :, 1],
                    centers[None, :, 2], radii[None, :],
                    jnp.ones((1, n_sph), bool))              # (M, P)
                is_hot = jnp.zeros((t_tiles,), bool).at[hot_ids].set(True)
                occ_full = jnp.zeros((t_tiles, tile_p), bool) \
                    .at[hot_ids].set(occ_h)
                occ_t = jnp.where(is_hot[:, None], occ_full, occ_t)
                # cold tiles above Ks = dropped occluders: never silent
                s_overflow.append(jnp.sum((s_count > ks) & ~is_hot,
                                          dtype=jnp.int32))
            else:
                s_overflow.append(jnp.sum(s_count > ks, dtype=jnp.int32))
        else:
            s_counts.append(zero_c)
            s_overflow.append(zero_o)

        if n_box:
            sb_idx, sb_valid, sb_cnt = _dense_compact(
                lpos, axis_s, cos_s, bc_bs, br_bs, ksb, max_dist=max_d,
                tile_valid=~empty_s)
            sbrows = _gather_tile_rows(btab, sb_idx)
            occ_t = occ_t | _box_segment_occluded(sbrows, sb_valid, so_t,
                                                  p_t, lpos)
            sb_counts.append(sb_cnt)
            sb_overflow.append(jnp.sum(sb_cnt > ksb, dtype=jnp.int32))
        else:
            sb_counts.append(zero_c)
            sb_overflow.append(zero_o)

        occ = occ_t.reshape(-1)                              # (R,)
        if pln.count:
            tpl, _, _ = plane_candidates(shadow_org,
                                         lpos[None, :] - hit.p,
                                         pln.normal, pln.offset,
                                         jnp.ones((pln.count,), bool),
                                         with_normals=False)
            occ = occ | jnp.any(tpl < 1.0, axis=-1)
        occ_cols.append(occ)

    occluded = jnp.stack(occ_cols, axis=-1) if n_lights else \
        jnp.zeros((r_total, 0), bool)
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


def cull_overflow_count(aux: CullAux) -> jnp.ndarray:
    """Device-side int32 scalar: number of (tile, list) slots whose true
    survivor count exceeded the static K actually used — i.e. renders where
    objects were DROPPED. Computed from the aux the forward already produced,
    so a training step can thread it out and check EVERY step for free
    (VERDICT r2 weak #8: the interval-gated recheck left silent gaps).
    s_overflow/sb_overflow already exclude hot tiles (they get dense passes).
    """
    kp_eff = aux.p_idx.shape[-1]
    kb_eff = aux.b_idx.shape[-1]
    ovf = jnp.sum(aux.p_count > kp_eff, dtype=jnp.int32)
    ovf = ovf + jnp.sum(aux.s_overflow, dtype=jnp.int32)
    if kb_eff:
        ovf = ovf + jnp.sum(aux.b_count > kb_eff, dtype=jnp.int32)
        ovf = ovf + jnp.sum(aux.sb_overflow, dtype=jnp.int32)
    return ovf


def culled_material_rows(scene: Scene, hit: Hit, aux: CullAux, tile_p: int):
    """Per-ray packed material rows (R, 20) routed through the tile survivor
    lists: gather materials for the (T, Kp) survivors (small), select the
    winner's row with the same one-hot contraction as the geometry fold, and
    patch plane winners through a tiny one-hot over the plane table. Replaces
    the O(R)-row global material gather that dominates shading time for
    large material tables (one material per sphere in the 4096-sphere
    config). Differentiable w.r.t. scene.materials (take + einsum), so
    material gradients flow exactly as through gather_materials."""
    from openglraytracer_tpu.ops.shading import material_table

    dtype = scene.spheres.center.dtype
    r_total = hit.t.shape[0]
    t_tiles = r_total // tile_p
    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    table = material_table(scene)                           # (K, 20)
    nfeat = table.shape[-1]

    rows = jnp.zeros((t_tiles, tile_p, nfeat), dtype)
    if n_sph:
        surv_mid = jnp.take(scene.spheres.material_id, aux.p_idx, axis=0)
        surv_rows = jnp.take(table, surv_mid, axis=0)       # (T, Kp, 20)
        kp_eff = aux.p_idx.shape[-1]
        sel = (aux.j_local[..., None]
               == jnp.arange(kp_eff, dtype=jnp.int32)[None, None, :])
        rows = rows + jnp.einsum("tpk,tkf->tpf", sel.astype(dtype),
                                 surv_rows,
                                 precision=jax.lax.Precision.HIGHEST)
    if n_box:
        surv_mid_b = jnp.take(scene.boxes.material_id, aux.b_idx, axis=0)
        surv_rows_b = jnp.take(table, surv_mid_b, axis=0)   # (T, Kb, 20)
        kb_eff = aux.b_idx.shape[-1]
        selb = (aux.jb_local[..., None]
                == jnp.arange(kb_eff, dtype=jnp.int32)[None, None, :])
        rows = rows + jnp.einsum("tpk,tkf->tpf", selb.astype(dtype),
                                 surv_rows_b,
                                 precision=jax.lax.Precision.HIGHEST)
    rows = rows.reshape(r_total, -1)

    pln = scene.planes
    if pln.count:
        pln_rows = jnp.take(table, pln.material_id, axis=0)  # (P, 20)
        is_pln = hit.hit & (hit.obj_id >= n_sph + n_box)
        pid = jnp.clip(hit.obj_id - n_sph - n_box, 0, pln.count - 1)
        oh = ((pid[:, None] == jnp.arange(pln.count, dtype=jnp.int32)[None])
              & is_pln[:, None]).astype(dtype)
        rows = rows + jnp.matmul(oh, pln_rows,
                                 precision=jax.lax.Precision.HIGHEST)
    return rows


# ---------------------------------------------------------------------------
# Custom VJP: tile-structured analytic backward
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8, 9))
def culled_geometry_op(scene: Scene, origins, dirs, tile_p: int, kp: int,
                       ks: int, shadow_lights: tuple | None = None,
                       hot_m: int = 0, kb: int = 0, ksb: int = 0):
    hit, occ, aux = culled_geometry(scene, origins, dirs, tile_p, kp, ks,
                                    shadow_lights, hot_m, kb, ksb)
    return hit, occ, aux


def _culled_fwd(scene, origins, dirs, tile_p, kp, ks, shadow_lights, hot_m,
                kb, ksb):
    hit, occ, aux = culled_geometry(scene, origins, dirs, tile_p, kp, ks,
                                    shadow_lights, hot_m, kb, ksb)
    return (hit, occ, aux), (scene, origins, dirs, hit, aux)


def _culled_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb, res, g):
    """Analytic winner-only backward (see ops/geometry.py) with the gather
    and scatter routed through the (tiles, K) survivor lists: O(R*K + T*K*N)
    one-hot contractions instead of O(R)-row global gathers/scatters. Box
    winners replay the slab test through _winner_recompute's box branch;
    the angles->rotation chain is differentiated per BOX (tiny vjp), not
    per ray."""
    from openglraytracer_tpu.ops.geometry import _winner_recompute
    from openglraytracer_tpu.ops.transforms import euler_rotation_3x3b

    scene, origins, dirs, hit, aux = res
    g_hit, _g_occ, _g_aux = g
    gt, gp, gn = g_hit.t, g_hit.p, g_hit.n

    n_sph = scene.spheres.count
    n_box = scene.boxes.count
    n_pln = scene.planes.count
    r_total = origins.shape[0]
    t_tiles = r_total // tile_p
    dtype = origins.dtype
    hi = jax.lax.Precision.HIGHEST

    idx = hit.obj_id
    hm = hit.hit
    is_sph = (hm & (idx >= 0) & (idx < n_sph)) if n_sph \
        else jnp.zeros_like(hm)
    is_box = (hm & (idx >= n_sph) & (idx < n_sph + n_box)) if n_box \
        else jnp.zeros_like(hm)

    # winner sphere params via the tile survivor lists (tiny gathers)
    if n_sph:
        table = jnp.concatenate([scene.spheres.center,
                                 scene.spheres.radius[:, None]], -1)  # (N,4)
        rows = _gather_tile_rows(table, aux.p_idx)          # (T, Kp, 4)
        sel = (aux.j_local[..., None] ==
               jnp.arange(rows.shape[1], dtype=jnp.int32)[None, None, :])
        win = jnp.einsum("tpk,tkf->tpf", sel.astype(dtype), rows,
                         precision=hi)                      # (T, P, 4)
        c = win[..., 0:3].reshape(-1, 3)
        r = win[..., 3].reshape(-1)
        r = jnp.where(is_sph, r, 1.0)
    else:
        c = jnp.zeros_like(origins)
        r = jnp.ones(r_total, dtype)

    # winner box params via the (T, Kb) survivor lists
    if n_box:
        rot_table, rot_vjp = jax.vjp(
            lambda a: euler_rotation_3x3b(a).reshape(n_box, 9),
            scene.boxes.angles)
        btab = jnp.concatenate([scene.boxes.mins, scene.boxes.maxs,
                                scene.boxes.position, rot_table],
                               axis=-1)                     # (M, 18)
        browst = _gather_tile_rows(btab, aux.b_idx)         # (T, Kb, 18)
        selb = (aux.jb_local[..., None] ==
                jnp.arange(browst.shape[1], dtype=jnp.int32)[None, None, :])
        winb = jnp.einsum("tpk,tkf->tpf", selb.astype(dtype), browst,
                          precision=hi).reshape(-1, 18)     # (R, 18)
        box_params = (winb[:, 0:3], winb[:, 3:6], winb[:, 6:9],
                      winb[:, 9:18].reshape(-1, 3, 3))
    else:
        box_params = None

    if n_pln:
        pid = jnp.clip(idx - n_sph - n_box, 0, n_pln - 1)
        pn = scene.planes.normal[pid]
        poff = scene.planes.offset[pid]
    else:
        pid = jnp.zeros_like(idx)
        pn = jnp.concatenate(
            [jnp.zeros((r_total, 2), dtype), jnp.ones((r_total, 1), dtype)],
            axis=-1)
        poff = jnp.zeros(r_total, dtype)

    live = hm
    gt = jnp.where(live, gt, 0.0)
    gn = jnp.where(live[:, None], gn, 0.0)
    gp_direct_o = jnp.where(live[:, None], 0.0, gp)
    gp = jnp.where(live[:, None], gp, 0.0)

    if n_box:
        def replay(c_, r_, pn_, poff_, bm_, bx_, bp_, brot_, o_, d_):
            return _winner_recompute(c_, r_, pn_, poff_, o_, d_, is_sph,
                                     hit.inside, hm,
                                     box_params=(bm_, bx_, bp_, brot_),
                                     is_box=is_box)
        _, vjp_fn = jax.vjp(replay, c, r, pn, poff, *box_params,
                            origins, dirs)
        gc, gr, gpn, gpoff, gbm, gbx, gbp, gbrot, go, gd = \
            vjp_fn((gt, gp, gn))
    else:
        _, vjp_fn = jax.vjp(
            lambda c_, r_, pn_, poff_, o_, d_: _winner_recompute(
                c_, r_, pn_, poff_, o_, d_, is_sph, hit.inside, hm),
            c, r, pn, poff, origins, dirs)
        gc, gr, gpn, gpoff, go, gd = vjp_fn((gt, gp, gn))
    go = go + gp_direct_o

    zero_like = functools.partial(
        jax.tree_util.tree_map,
        lambda x: (jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
                   else np.zeros(x.shape, jax.dtypes.float0)))
    g_scene = zero_like(scene)

    if n_sph:
        contrib = jnp.concatenate([gc, gr[:, None]], -1)
        contrib = jnp.where(is_sph[:, None], contrib, 0.0)
        contrib_t = contrib.reshape(t_tiles, tile_p, 4)
        # stage 1: rays -> tile survivor slots (per-tile one-hot transpose)
        g_rows = jnp.einsum("tpk,tpf->tkf", sel.astype(dtype), contrib_t,
                            precision=hi)                   # (T, Kp, 4)
        # stage 2: (T*Kp) slots -> N objects (small one-hot scatter)
        flat_idx = aux.p_idx.reshape(-1)
        oh = (flat_idx[:, None]
              == jnp.arange(n_sph, dtype=jnp.int32)[None, :]).astype(dtype)
        g_sph = jnp.matmul(oh.T, g_rows.reshape(-1, 4),
                           precision=hi)                    # (N, 4)
        g_scene = g_scene._replace(spheres=g_scene.spheres._replace(
            center=g_sph[:, :3], radius=g_sph[:, 3]))
    if n_box:
        g_brow = jnp.concatenate(
            [jnp.where(is_box[:, None], g_, 0.0)
             for g_ in (gbm, gbx, gbp, gbrot.reshape(-1, 9))], axis=-1)
        g_rows_b = jnp.einsum("tpk,tpf->tkf", selb.astype(dtype),
                              g_brow.reshape(t_tiles, tile_p, 18),
                              precision=hi)                 # (T, Kb, 18)
        flat_b = aux.b_idx.reshape(-1)
        ohb = (flat_b[:, None]
               == jnp.arange(n_box, dtype=jnp.int32)[None, :]).astype(dtype)
        g_box = jnp.matmul(ohb.T, g_rows_b.reshape(-1, 18),
                           precision=hi)                    # (M, 18)
        (g_angles,) = rot_vjp(g_box[:, 9:18])
        g_scene = g_scene._replace(boxes=g_scene.boxes._replace(
            mins=g_box[:, 0:3], maxs=g_box[:, 3:6],
            position=g_box[:, 6:9], angles=g_angles))
    if n_pln:
        from openglraytracer_tpu.ops.gathers import scatter_add_rows
        pln_mask = hm & (~is_sph) & (~is_box)
        gpn = jnp.where(pln_mask[:, None], gpn, 0.0)
        gpoff = jnp.where(pln_mask, gpoff, 0.0)
        g_rows = scatter_add_rows(
            pid, jnp.concatenate([gpn, gpoff[:, None]], -1), n_pln)
        g_scene = g_scene._replace(planes=g_scene.planes._replace(
            normal=g_rows[:, :3], offset=g_rows[:, 3]))

    return g_scene, go, gd


culled_geometry_op.defvjp(_culled_fwd, _culled_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9, 10))
def bounce_culled_geometry_op(scene: Scene, origins, dirs, active,
                              tile_p: int, kp: int, ks: int,
                              shadow_lights: tuple | None = None,
                              hot_m: int = 0, kb: int = 0, ksb: int = 0):
    """culled_geometry in SECONDARY-RAY mode (per-ray origins + active mask)
    with the same tile-structured analytic VJP as culled_geometry_op —
    _culled_bwd never assumed a shared origin (_winner_recompute replays
    per-ray), so the backward is shared verbatim; the active mask is a
    boolean input whose cotangent is float0."""
    return culled_geometry(scene, origins, dirs, tile_p, kp, ks,
                           shadow_lights, hot_m, kb, ksb, active=active)


def _bounce_culled_fwd(scene, origins, dirs, active, tile_p, kp, ks,
                       shadow_lights, hot_m, kb, ksb):
    hit, occ, aux = culled_geometry(scene, origins, dirs, tile_p, kp, ks,
                                    shadow_lights, hot_m, kb, ksb,
                                    active=active)
    return (hit, occ, aux), (scene, origins, dirs, hit, aux, active.shape)


def _bounce_culled_bwd(tile_p, kp, ks, shadow_lights, hot_m, kb, ksb,
                       res, g):
    *core, a_shape = res
    g_scene, go, gd = _culled_bwd(tile_p, kp, ks, shadow_lights, hot_m,
                                  kb, ksb, tuple(core), g)
    return g_scene, go, gd, np.zeros(a_shape, jax.dtypes.float0)


bounce_culled_geometry_op.defvjp(_bounce_culled_fwd, _bounce_culled_bwd)


# ---------------------------------------------------------------------------
# Host-side K sizing
# ---------------------------------------------------------------------------

def cull_counts(scene: Scene, camera, height: int, width: int,
                tile=(32, 32), shadow_lights: tuple | None = None):
    """Per-tile survivor counts for K sizing: (primary (T,), shadow (L, T),
    box-primary (T,), box-shadow (L, T)).

    Two cheap jitted passes: (1) primary-cone mask sums (no narrow phase),
    (2) a narrow-phase pass at the just-measured kp — shadows disabled — to
    get hit positions, from which the per-light shadow-cone mask sums follow.
    Memory stays O(tiles x N) bools; never materializes (T*N)-row gathers.
    """
    from openglraytracer_tpu.ops.raygen import generate_rays

    th, tw = tile
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    tile_p = th * tw
    n_sph = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    n = max(n_sph, 1)
    n_lights = scene.lights.count
    t_tiles = o.shape[0] // tile_p

    @jax.jit
    def primary_counts(scene, o, d):
        dirs_t = d.reshape(-1, tile_p, 3)
        axis, cos_half = tile_cones(dirs_t)
        zero = jnp.zeros((t_tiles,), jnp.int32)
        pc = zero
        if n_sph:
            mask = sphere_vs_cone(o[0], axis, cos_half, scene.spheres.center,
                                  scene.spheres.radius)
            pc = jnp.sum(mask, axis=-1, dtype=jnp.int32)
        pb = zero
        if n_box:
            bc, br = box_bounding_spheres(scene)
            pb = jnp.sum(sphere_vs_cone(o[0], axis, cos_half, bc, br),
                         axis=-1, dtype=jnp.int32)
        return pc, pb

    p_count, pb_count = primary_counts(scene, o, d)
    kp0 = min(n, max(8, int(jnp.max(p_count))))

    no_shadows = tuple([False] * n_lights)

    @jax.jit
    def shadow_counts(scene, o, d):
        hit, _, _ = culled_geometry(scene, o, d, tile_p, kp0, 8, no_shadows)
        shadow_org = hit.p + hit.n * SHADOW_EPS
        cols = []
        bcols = []
        if n_box:
            bc, br = box_bounding_spheres(scene)
        zero = jnp.zeros(p_count.shape, jnp.int32)
        for li in range(n_lights):
            if shadow_lights is not None and not shadow_lights[li]:
                cols.append(zero)
                bcols.append(zero)
                continue
            lpos = scene.lights.position[li]
            if n_sph:
                smask = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p,
                                         lpos)
                cols.append(jnp.sum(smask, axis=-1, dtype=jnp.int32))
            else:
                cols.append(zero)
            if n_box:
                bmask = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p,
                                         lpos, centers=bc, radii=br)
                bcols.append(jnp.sum(bmask, axis=-1, dtype=jnp.int32))
            else:
                bcols.append(zero)
        empty = jnp.zeros((0,) + p_count.shape, jnp.int32)
        return (jnp.stack(cols) if cols else empty,
                jnp.stack(bcols) if bcols else empty)

    s_count, sb_count = shadow_counts(scene, o, d)
    return p_count, s_count, pb_count, sb_count


def suggest_cull_sizes(scene: Scene, camera, height: int, width: int,
                       tile=(32, 32), headroom: float = 1.5,
                       min_k: int = 8,
                       shadow_lights: tuple | None = None) -> tuple[int, int]:
    """(kp, ks) with headroom over the observed max survivor counts, rounded
    up to a multiple of 8 and clipped to N. Headroom matters when the scene
    will move (inverse-rendering fits). Lights disabled by shadow_lights
    don't contribute to ks (ambient-only lights would otherwise force
    ks = N — their apex sits inside the scene). Sphere sizes only — box
    survivor lists default to dense (complete); use suggest_cull_config for
    box-aware specs."""
    if shadow_lights is None:
        from openglraytracer_tpu.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    p_count, s_count, _, _ = cull_counts(scene, camera, height, width, tile,
                                         shadow_lights)
    n = int(scene.spheres.count)

    def size(c):
        k = int(np.ceil(float(jnp.max(c)) * headroom))
        return max(min_k, min(n, -(-k // 8) * 8))

    ks = size(s_count) if s_count.size else min_k
    return size(p_count), ks


def check_cull_overflow(scene: Scene, camera, height: int, width: int,
                        cull, shadow_lights: tuple | None = None):
    """Recount survivors for the CURRENT scene against a fixed cull spec
    ``((th, tw), kp, ks[, hot_m[, kb, ksb]])`` and report dropped-object
    risk.

    Returns None when the spec still covers every tile, else a dict with the
    observed maxima and re-suggested sizes. Used by the fit loop: a moving
    scene can outgrow the once-computed K — accel.py's contract is that
    overflow is never silent (ADVICE r1 #3).

    Caveat (r4): this host-side recount is advisory; the authoritative
    signal is the device-side counter threaded out of every step
    (with_cull_stats / fit's cull_overflow scalar). The engines run dense
    per-tile compaction only (the two-level coarse level was withdrawn —
    see culled_geometry's rationale), so the dense counts measured here
    model exactly what the runtime compacts; fit specs still use
    suggest_cull_config(hot=False) with headroom because a moving scene can
    outgrow a once-computed K between recounts."""
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    p_count, s_count, pb_count, sb_count = cull_counts(
        scene, camera, height, width, (th, tw), shadow_lights)
    n_box = int(scene.boxes.count)
    kb = min(kb, n_box) if kb > 0 else n_box
    ksb = min(ksb, n_box) if ksb > 0 else n_box
    max_p = int(jnp.max(p_count))
    if s_count.size:
        counts = np.sort(np.asarray(s_count), axis=-1)[:, ::-1]  # (L,T) desc
        # hot tiles get the dense pass — only the (hot_m+1)-th largest count
        # onward must fit in ks
        cold_max = int(counts[:, min(hot_m, counts.shape[-1] - 1)].max()) \
            if hot_m < counts.shape[-1] else 0
    else:
        cold_max = 0
    max_pb = int(jnp.max(pb_count)) if n_box else 0
    max_sb = int(np.max(np.asarray(sb_count))) \
        if (n_box and sb_count.size) else 0
    if max_p <= kp and cold_max <= ks and max_pb <= kb and max_sb <= ksb:
        return None
    return {"max_primary": max_p, "kp": kp,
            "max_shadow_cold": cold_max, "ks": ks,
            "max_box_primary": max_pb, "kb": kb,
            "max_box_shadow": max_sb, "ksb": ksb,
            "suggest_kp": max(kp, -(-max_p // 8) * 8),
            "suggest_ks": max(ks, -(-cold_max // 8) * 8),
            "suggest_kb": max(kb, max_pb),
            "suggest_ksb": max(ksb, max_sb)}


def suggest_cull_config(scene: Scene, camera, height: int, width: int,
                        tile=(32, 32), headroom: float = 1.5,
                        min_k: int = 8,
                        shadow_lights: tuple | None = None,
                        hot: bool = True):
    """Full cull spec — ((th, tw), kp, ks, hot_m) for sphere/plane scenes,
    ((th, tw), kp, ks, hot_m, kb, ksb) when the scene has OBBs — with the
    hot-tile shadow strategy: sweep M over a small grid and pick the
    (ks(M), M) minimizing the modeled narrow-phase cost T*ks + M*N per light
    — ks(M) is the (M+1)-th largest per-tile occluder count, i.e. the max
    over the COLD tiles, so cold tiles never drop occluders at suggestion
    time. Box sizes are max-count based (box populations are small).

    hot=False sizes ks from the GLOBAL max (x headroom) with hot_m = 0 —
    the right strategy for the dynamic-trip-count Pallas engine (r4): each
    tile scans only its true count, so a long static K costs list memory
    (cheap) instead of scan work, and the XLA dense hot pass would be pure
    overhead."""
    if shadow_lights is None:
        from openglraytracer_tpu.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    p_count, s_count, pb_count, sb_count = cull_counts(
        scene, camera, height, width, tile, shadow_lights)
    return _spec_from_counts(scene, p_count, s_count, pb_count, sb_count,
                             tile, headroom, min_k, hot)


def _spec_from_counts(scene: Scene, p_count, s_count, pb_count, sb_count,
                      tile, headroom: float, min_k: int, hot: bool = True,
                      hot_primary: bool = False, w_count=None):
    """Size a cull spec from measured survivor counts (shared by
    suggest_cull_config and suggest_child_cull_config).

    hot_primary=True (secondary/bounce specs only, r5): also size a
    hot-PRIMARY tile budget with the same quantile/cost model the shadow
    lists use — Kp becomes a quantile cap and the hot_p over-cap tiles run
    a dense global-table kernel pass (see cull_hot_p). The m grid extends
    to T/2 because bounce-count distributions are far heavier-tailed than
    shadow counts (mirror4096: p50 = 0, p90 = N). w_count (T,) measured
    DISTINCT-winner counts floors Kp so the posthoc winner lists the hot
    pass rebuilds for the backward/material routing never overflow at the
    measured frame."""
    n = int(scene.spheres.count)
    n_box = int(scene.boxes.count)

    def rounded(k):
        return max(min_k, min(n, -(-int(np.ceil(k * headroom)) // 8) * 8))

    def box_spec():
        if not n_box:
            return (0, 0) if hot_primary else ()
        kb = max(1, min(n_box, int(np.ceil(int(jnp.max(pb_count))
                                           * headroom))))
        max_sb = int(np.max(np.asarray(sb_count))) if sb_count.size else 0
        ksb = max(1, min(n_box, int(np.ceil(max_sb * headroom))))
        return (kb, ksb)

    hot_p = 0
    if hot_primary and n:
        counts_p = np.sort(np.asarray(p_count))[::-1]        # (T,) desc
        t_tiles = counts_p.shape[0]
        w_floor = rounded(int(np.max(np.asarray(w_count)))) \
            if w_count is not None and np.asarray(w_count).size else min_k
        best = None
        for m in [0] + [max(1, t_tiles // f) for f in (64, 32, 16, 8, 4, 2)]:
            kp_m = int(counts_p[min(m, t_tiles - 1)]) if m < t_tiles else 0
            kp_m = max(rounded(kp_m), w_floor)
            # same cost units as the shadow model: per-tile list work
            # (gather + scan, 64-lane floor) + m dense all-N scans
            cost = t_tiles * max(kp_m, 64) + m * n
            if best is None or cost < best[0]:
                best = (cost, kp_m, m)
        _, kp, hot_p = best
    else:
        kp = rounded(int(jnp.max(p_count))) if n else min_k
    tail = (hot_p,) if hot_primary else ()
    if not s_count.size:
        return (tile, kp, min_k, 0) + box_spec() + tail

    if not hot:
        ks = rounded(int(np.max(np.asarray(s_count))))
        return (tile, kp, ks, 0) + box_spec() + tail

    counts = np.sort(np.asarray(s_count), axis=-1)[:, ::-1]  # (L, T) desc
    t_tiles = counts.shape[-1]
    best = None
    for m in [0] + [max(1, t_tiles // f) for f in (64, 32, 16, 8)]:
        ks_m = int(counts[:, min(m, t_tiles - 1)].max()) if m < t_tiles \
            else 0
        ks_m = rounded(ks_m)
        # cost model: per-tile fixed costs put a floor of ~64 rows under
        # each list's cost, so reductions below that never pay for the hot
        # pass (a modelling choice, not re-measured on the GPU)
        cost = t_tiles * max(ks_m, 64) + m * n
        if best is None or cost < best[0]:
            best = (cost, ks_m, m)
    _, ks, hot_m = best
    if n == 0:
        hot_m = 0                       # the hot pass is a sphere-only path
    return (tile, kp, ks, hot_m) + box_spec() + tail


def bounce_cull_counts(scene: Scene, camera, height: int, width: int,
                       cull, shadow_lights: tuple | None = None):
    """Per-tile survivor counts for the BOUNCE children of a culled trace —
    the sizing pass for secondary-ray culling (VERDICT r2 next #4).

    Traces the primaries once (shadows off) with the parent spec ``cull``,
    spawns the reflection AND (when any material is transparent) refraction
    bundles, and measures (1) bounce-cone sphere/box survivor counts and
    (2) per-light shadow-cone counts from the children's own hit points
    (obtained by an exact child pass at Kp = measured max). Counts are the
    elementwise max over the live branches, so one child spec conservatively
    covers both (ADVICE r3: refraction cones can be wider than reflection's).
    Returns (p_count (T,), s_count (L, T), pb_count (T,), sb_count (L, T)).

    Caveat (documented, per ADVICE r3): counts are measured at bounce level
    1. Deeper levels reuse the same spec; their cones are usually narrower
    (each bounce's active set shrinks) but are not *guaranteed* to be —
    renders at depth >= 2 should verify via with_cull_stats (the per-level
    overflow counters cover every level) or the headroom factor.
    """
    from openglraytracer_tpu.ops.raygen import generate_rays
    from openglraytracer_tpu.ops.render import BOUNCE_EPS
    from openglraytracer_tpu.ops.transforms import reflect, refract
    from openglraytracer_tpu.models.scene import AIR_IOR

    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(cull)
    tile_p = th * tw
    origins, dirs = generate_rays(camera, height, width)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    n_sph = int(scene.spheres.count)
    n_box = int(scene.boxes.count)
    n_lights = scene.lights.count
    t_tiles = o.shape[0] // tile_p
    no_shadows = tuple([False] * n_lights)
    from openglraytracer_tpu.ops.shading import static_bounce_mask
    has_refl, has_refr = static_bounce_mask(scene)

    def bundle_counts(scene, co, cd, active):
        act_t = (active & (jnp.sum(cd * cd, -1) > _DIV_EPS)) \
            .reshape(t_tiles, tile_p)
        apex, axis, cos_half, rho, empty = bounce_cones(
            co.reshape(t_tiles, tile_p, 3), cd.reshape(t_tiles, tile_p, 3),
            act_t)
        zero = jnp.zeros((t_tiles,), jnp.int32)
        pc = pb = zero
        if n_sph:
            m = sphere_vs_cone(apex, axis, cos_half, scene.spheres.center,
                               scene.spheres.radius, expand=rho)
            pc = jnp.sum(m & (~empty)[:, None], axis=-1, dtype=jnp.int32)
        if n_box:
            bc, br = box_bounding_spheres(scene)
            m = sphere_vs_cone(apex, axis, cos_half, bc, br, expand=rho)
            pb = jnp.sum(m & (~empty)[:, None], axis=-1, dtype=jnp.int32)
        return pc, pb

    @jax.jit
    def child_masks(scene, o, d):
        hit, _, _ = culled_geometry(scene, o, d, tile_p, kp, 8, no_shadows,
                                    0, kb, ksb)
        zero = jnp.zeros((t_tiles,), jnp.int32)
        pc = pb = zero
        bundles = []
        if has_refl:
            refl = jnp.take(scene.materials.reflectivity, hit.material_id)
            active = hit.hit & (refl > 0.0)
            co = hit.p + hit.n * BOUNCE_EPS
            cd = reflect(d, hit.n)
            pc, pb = bundle_counts(scene, co, cd, active)
            bundles.append((active, co, cd))
        if has_refr:
            tau = jnp.take(scene.materials.transparency, hit.material_id)
            active_r = hit.hit & (tau > 0.0)
            ior = jnp.take(scene.materials.refraction_index, hit.material_id)
            ratio = jnp.where(hit.inside, ior / AIR_IOR, AIR_IOR / ior)
            co_r = hit.p - hit.n * BOUNCE_EPS
            cd_r = refract(d, hit.n, ratio[:, None])
            pc_r, pb_r = bundle_counts(scene, co_r, cd_r, active_r)
            pc, pb = jnp.maximum(pc, pc_r), jnp.maximum(pb, pb_r)
            bundles.append((active_r, co_r, cd_r))
        return pc, pb, bundles

    p_count, pb_count, bundles = child_masks(scene, o, d)
    kp_c = min(max(n_sph, 1), max(8, int(jnp.max(p_count))))
    kb_c = max(1, int(jnp.max(pb_count))) if n_box else 0

    @jax.jit
    def child_shadow_counts(scene, co, cd, active):
        # kp_c is the MAXIMUM bounce-cone count, up to N on curved-mirror
        # scenes: the XLA narrow phase would materialize (T, N, P) candidate
        # blocks (16 GiB each at c4_mirror4096), the kernels only the
        # (T, N, 8) survivor rows
        from openglraytracer_tpu.ops.pallas_culled import (
            culled_geometry_pallas)
        hit, _, _ = culled_geometry_pallas(scene, co, cd, tile_p, kp_c, 8,
                                           no_shadows, 0, kb_c, 1,
                                           active=active)
        # DISTINCT-winner counts per tile (r5 hot-primary sizing): the hot
        # pass rebuilds per-tile winner lists capped at Kp for the analytic
        # backward; Kp must cover the measured winner sets (<< survivor
        # sets: a 1024-ray tile rarely hits more than a few hundred
        # distinct objects even when its cone keeps all N)
        gid_t = hit.obj_id.reshape(t_tiles, tile_p)
        tt = jnp.arange(t_tiles, dtype=jnp.int32)[:, None]

        def distinct(lo, hi_n):
            if not hi_n:
                return jnp.zeros((t_tiles,), jnp.int32)
            is_w = hit.hit.reshape(t_tiles, tile_p) \
                & (gid_t >= lo) & (gid_t < lo + hi_n)
            wm = jnp.zeros((t_tiles, hi_n), jnp.int32).at[
                tt, jnp.clip(gid_t - lo, 0, hi_n - 1)].max(
                is_w.astype(jnp.int32))
            return jnp.sum(wm, axis=-1, dtype=jnp.int32)

        w_cnt = distinct(0, n_sph)
        wb_cnt = distinct(n_sph, n_box)
        shadow_org = hit.p + hit.n * SHADOW_EPS
        if n_box:
            bc, br = box_bounding_spheres(scene)
        cols, bcols = [], []
        zero = jnp.zeros((t_tiles,), jnp.int32)
        for li in range(n_lights):
            if shadow_lights is not None and not shadow_lights[li]:
                cols.append(zero)
                bcols.append(zero)
                continue
            lpos = scene.lights.position[li]
            if n_sph:
                sm = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p,
                                      lpos)
                cols.append(jnp.sum(sm, axis=-1, dtype=jnp.int32))
            else:
                cols.append(zero)
            if n_box:
                bm = shadow_cull_mask(scene, shadow_org, hit.hit, tile_p,
                                      lpos, centers=bc, radii=br)
                bcols.append(jnp.sum(bm, axis=-1, dtype=jnp.int32))
            else:
                bcols.append(zero)
        empty = jnp.zeros((0, t_tiles), jnp.int32)
        return (jnp.stack(cols) if cols else empty,
                jnp.stack(bcols) if bcols else empty, w_cnt, wb_cnt)

    # shadow counts from each live branch's own child hit points; one spec
    # covers both via elementwise max (ADVICE r3)
    s_count = sb_count = w_count = wb_count = None
    for active, co, cd in bundles:
        sc, sbc, wc, wbc = child_shadow_counts(scene, co, cd, active)
        s_count = sc if s_count is None else jnp.maximum(s_count, sc)
        sb_count = sbc if sb_count is None else jnp.maximum(sb_count, sbc)
        w_count = wc if w_count is None else jnp.maximum(w_count, wc)
        wb_count = wbc if wb_count is None else jnp.maximum(wb_count, wbc)
    if s_count is None:   # statically no live bounce branch
        s_count = sb_count = jnp.zeros((0, t_tiles), jnp.int32)
        w_count = wb_count = jnp.zeros((t_tiles,), jnp.int32)
    return p_count, s_count, pb_count, sb_count, w_count, wb_count


def suggest_child_cull_config(scene: Scene, camera, height: int, width: int,
                              cull, headroom: float = 1.5, min_k: int = 8,
                              shadow_lights: tuple | None = None,
                              hot_primary: bool = True):
    """Cull spec for the REFLECTION children of a culled trace: measure the
    bounce-bundle survivor counts (bounce_cull_counts) and size with the
    same quantile/hot-tile strategy as the primary spec. ``cull`` is the
    PARENT spec (its tile defines the child tiles — children inherit the
    parent's tile-major ray order elementwise).

    hot_primary=True (default, r5): Kp is a quantile cap plus a hot_p
    budget of over-cap tiles for the dense global-table pass (a
    culled_pallas feature, see cull_hot_p). Pass False when the consumer
    is the XLA child path (accel.bounce_culled_geometry_op), which has no
    hot pass — it gets the old max-count sizing so nothing truncates."""
    if shadow_lights is None:
        from openglraytracer_tpu.ops.shading import static_shadow_mask
        shadow_lights = static_shadow_mask(scene)
    tile = parse_cull_spec(cull)[0]
    p_count, s_count, pb_count, sb_count, w_count, wb_count = \
        bounce_cull_counts(scene, camera, height, width, cull, shadow_lights)
    return _spec_from_counts(scene, p_count, s_count, pb_count, sb_count,
                             tile, headroom, min_k,
                             hot_primary=hot_primary, w_count=w_count)


def suggest_stack_cull_config(scene: Scene, camera, height: int, width: int,
                              tile: tuple, headroom: float = 1.5,
                              shadow_lights: tuple | None = None):
    """Cull spec covering EVERY step of the culled stack engine
    (render.trace_rays_stack with cull — r5, VERDICT r4 next #5): the
    elementwise max of the primary spec and the depth-1 bounce-child spec
    (hot_m cleared — the hot-tile shadow override is sized against primary
    hit statistics and does not transfer to bounce bundles). Deeper levels'
    bundles are narrower in practice than depth-1's; the per-step overflow
    counter remains the authoritative never-silent check."""
    prim = suggest_cull_config(scene, camera, height, width, tile,
                               headroom=headroom, hot=False,
                               shadow_lights=shadow_lights)
    child = suggest_child_cull_config(scene, camera, height, width, prim,
                                      headroom=headroom,
                                      shadow_lights=shadow_lights)
    _, pkp, pks, _, pkb, pksb = parse_cull_spec(prim)
    _, ckp, cks, _, ckb, cksb = parse_cull_spec(child)
    # hot_p = EVERY tile (r5): the stack engine reuses one spec for all
    # 2^(depth+1)-1 DFS steps, and deep refractive bundles' over-cap tile
    # counts are not bounded by the depth-1 measurement the child spec's
    # budget comes from (measured: hot_p = 256 left 1675 overflow events
    # at depth 4 on the 4096-glass grid). The dense pass is trip-count
    # gated — tiles under the cap scan 0 rows — so an all-tiles budget
    # costs only the per-step top_k and makes primary-list overflow
    # structurally impossible; remaining overflow = winner-list overflow
    # (> kp distinct winners in one tile), still surfaced per step.
    t_tiles = (height // tile[0]) * (width // tile[1])
    hot_p = t_tiles if cull_hot_p(child) else 0
    kp = max(pkp, ckp)
    if hot_p:
        # winner-overflow-proof Kp: a tile of tile_p rays hits at most
        # tile_p distinct objects, so flooring Kp at min(N, tile_p) makes
        # the posthoc winner lists structurally complete at EVERY depth
        # (measured: the depth-1-sized cap of 296 left 1675 winner-overflow
        # events at depth 4 — deep refractive bundles are incoherent enough
        # that one tile's rays hit >296 distinct spheres)
        n_obj = int(scene.spheres.count)
        kp = max(kp, min(n_obj, tile[0] * tile[1]))
    return (tile, kp, max(pks, cks), 0,
            max(pkb, ckb), max(pksb, cksb), hot_p)
