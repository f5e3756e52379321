"""Soft-coverage differentiable forward: the silhouette-aware FIT path.

Why this exists (VERDICT r4 next #2): the production engines implement hard
visibility — ``jnp.where`` masks over exact nearest hits — whose gradients
are *straight-through*: a sphere's silhouette carries zero derivative, so an
inverse-rendering fit can recover shading-interior signal but is blind to
coverage mismatch (the r4 c5 fit plateaued at 22% center-error reduction for
exactly this reason, artifacts/c5_fit/summary.json). The differentiable
rendering literature (SoftRas, Dr.Jit reparameterization; PAPERS.md) solves
it by smoothing the forward, not the loss: coverage becomes a sigmoid over
the ray-silhouette distance and depth ordering becomes a softmax over hit
distances, both annealed toward hard during optimization.

This module is that opt-in forward. It is a FIT tool, not a render engine:

  * Coverage: ``alpha_i = sigmoid((1 - (d_perp/r)^2) / bw)`` per sphere —
    exactly the hard hit test ``d_perp < r`` as ``bw -> 0``. The logit is
    dimensionless (normalized by r^2) so one bandwidth works across mixed
    sphere sizes.
  * Depth: SoftRas-style aggregation ``w_i = alpha_i * exp(-t_i / gamma)``
    normalized over {spheres, planes, background}; the exact nearest-hit
    winner as ``gamma -> 0``. Exponents are computed relative to the per-ray
    min-t so they never overflow.
  * Shading: the same Phong ADS terms as ops/shading.phong_core (including
    the reference's rgb*alpha quirk, raytrace_compute.glsl:839) — but
    SHADOWLESS: soft shadow visibility over 4096 potential occluders per
    element is not worth its cost for a fit stage. Fit curricula therefore
    compare soft renders against soft-rendered targets (same bw/gamma), for
    which the true scene is an exact global optimum; the final fit stage
    switches to the hard engines against the real shadowed target.
  * Primitives: spheres + planes (the graded fit configs, BASELINE.json
    config 1/3/5). Boxes raise — the fit path has no box scenes.

Scaling: a dense (R x N) pass is fine for tests but not for c5 (4096
spheres); the broad phase reuses accel.py's tile cones with every radius
inflated to cover the sigmoid's support (``expand_factor``), compacted to
per-tile survivor lists under the same never-silent overflow contract as the
hard culled engines. Tiles are processed in ``lax.map`` blocks to bound the
(T, P, K) working set.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from openglraytracer_tpu.models.scene import Scene
from openglraytracer_tpu.ops.intersect import _safe_normalize, _safe_sqrt
from openglraytracer_tpu.ops.shading import _safe_pow, material_table

# alpha = sigmoid(logit) is ~3e-4 at logit = -8: inflating every radius so
# the cone cull keeps spheres down to that alpha bounds the compositing
# error of culling at ~1e-3 in the darkest channel — below fit-loss noise.
_LOGIT_REACH = 8.0
_T_EPS = 1.0e-3          # front-facing gate (reference eps family: 0.001)
# Coverage below this is cut to exactly zero. Two reasons: (a) the depth
# softmax would otherwise let an alpha ~ 1e-9 sphere "win" a pixel because
# the background's exp((t_min - t_bg)/gamma) underflows to 0 — a visible
# halo artifact and a 1/den blowup in the VJP (measured NaN at f32);
# (b) it bounds the error of the expanded-radius cull. The useful
# silhouette-gradient band is alpha in [~1e-2, 1], far above the cut.
_ALPHA_CUT = 1.0e-3


def expand_factor(bw: float) -> float:
    """Radius inflation covering the sigmoid's support: alpha(logit=-8)
    is negligible, and (d/r)^2 = 1 + 8*bw there."""
    return math.sqrt(1.0 + _LOGIT_REACH * float(bw))


def suggest_soft_cull(scene: Scene, camera, height: int, width: int,
                      tile: tuple, bw: float, headroom: float = 1.5):
    """Size the soft broad phase: max per-tile survivor count with
    bw-expanded radii, times headroom (a MOVING fit scene can outgrow the
    once-computed K — same contract as accel.suggest_cull_config).
    Returns ((th, tw), k)."""
    from openglraytracer_tpu.ops.accel import (sphere_vs_cone, tile_cones,
                                               tile_image)
    from openglraytracer_tpu.ops.raygen import generate_rays
    th, tw = tile
    origins, dirs = generate_rays(camera, height, width)
    dirs_t = tile_image(dirs, th, tw)
    axis, cos_half = tile_cones(dirs_t)
    apex = origins.reshape(-1, 3)[0]
    mask = sphere_vs_cone(apex, axis, cos_half, scene.spheres.center,
                          scene.spheres.radius * expand_factor(bw))
    kmax = int(jnp.max(jnp.sum(mask, axis=-1)))
    # round up to a multiple of 32: cameras with similar coverage land on
    # the SAME k, so multi-view fits share one compiled step instead of
    # paying a compile per view
    k = max(32, -(-int(math.ceil(kmax * headroom)) // 32) * 32)
    return (th, tw), min(k, int(scene.spheres.count))


def _phong_terms(m_rows, lights, px, py, pz, nx, ny, nz, dx, dy, dz):
    """Shadowless Phong ADS over component arrays of any broadcastable
    shape (...,). m_rows (..., 20) packed material_table rows. Returns
    (r, g, b) composited as phong.rgb * phong.a (glsl:839)."""
    m_amb = m_rows[..., 0:4]
    m_diff = m_rows[..., 4:8]
    m_spec = m_rows[..., 8:12]
    m_emis = m_rows[..., 12:16]
    m_shin = m_rows[..., 16]

    inv = jax.lax.rsqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-20))
    vx, vy, vz = -dx * inv, -dy * inv, -dz * inv        # view dir

    acc = jnp.zeros(m_amb.shape[:-1] + (4,), m_amb.dtype)
    for j in range(lights.position.shape[0]):
        lp = lights.position[j]
        acc = acc + lights.ambient[j] * m_amb
        tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
        linv = jax.lax.rsqrt(jnp.maximum(tlx * tlx + tly * tly + tlz * tlz,
                                         1e-20))
        lx, ly, lz = tlx * linv, tly * linv, tlz * linv
        cos_t = lx * nx + ly * ny + lz * nz
        # reflect(-l, n) = l - 2*dot(l,n)*n ... with phong_core's convention
        # light_ref = normalize(reflect(-light_dir, n)) = 2*cos_t*n - l
        rx, ry, rz = 2 * cos_t * nx - lx, 2 * cos_t * ny - ly, \
            2 * cos_t * nz - lz
        rinv = jax.lax.rsqrt(jnp.maximum(rx * rx + ry * ry + rz * rz, 1e-20))
        cos_p = (rx * vx + ry * vy + rz * vz) * rinv
        acc = acc + lights.diffuse[j] * m_diff \
            * jnp.maximum(cos_t, 0.0)[..., None]
        acc = acc + lights.specular[j] * m_spec \
            * _safe_pow(cos_p, m_shin)[..., None]
    acc = acc + m_emis
    out = acc[..., :3] * acc[..., 3:4]
    return out[..., 0], out[..., 1], out[..., 2]


def _composite_block(scene: Scene, mat_tab, o, d, sph_rows, sph_valid,
                     bw: float, gamma: float, t_bg: float):
    """Soft composite for one block.

    o, d: (B, P, 3); sph_rows (B, K, 6) [cx cy cz r mat gid] survivor rows
    (or (1, N, 6) dense); sph_valid (B, K). Returns (B, P, 3)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]          # (B, P)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    cx = sph_rows[..., 0][:, None, :]                     # (B, 1, K)
    cy = sph_rows[..., 1][:, None, :]
    cz = sph_rows[..., 2][:, None, :]
    rr = sph_rows[..., 3][:, None, :]
    ocx = ox[..., None] - cx                              # (B, P, K)
    ocy = oy[..., None] - cy
    ocz = oz[..., None] - cz
    b = ocx * dx[..., None] + ocy * dy[..., None] + ocz * dz[..., None]
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    r2 = jnp.maximum(rr * rr, 1e-12)
    disc = r2 - (oc2 - b * b)                             # r^2 - d_perp^2
    logit = disc / (bw * r2)
    alpha = jax.nn.sigmoid(logit)
    # _safe_sqrt: sqrt(max(disc, eps)) keeps the silhouette derivative
    # finite (plain sqrt(max(disc, 0)) yields 0 * inf = NaN in the VJP
    # exactly on the silhouette)
    t_hit = -b - _safe_sqrt(disc)                         # closest approach
    front = (t_hit > _T_EPS) & sph_valid[:, None, :]      # on miss (disc<0)
    alpha = jnp.where(front & (alpha > _ALPHA_CUT), alpha, 0.0)
    t_sph = jnp.clip(t_hit, _T_EPS, t_bg)

    # sphere shading at p = o + t*d, n = (p - c)/|p - c|
    px = ox[..., None] + t_sph * dx[..., None]
    py = oy[..., None] + t_sph * dy[..., None]
    pz = oz[..., None] + t_sph * dz[..., None]
    nx_, ny_, nz_ = px - cx, py - cy, pz - cz
    ninv = jax.lax.rsqrt(jnp.maximum(nx_ * nx_ + ny_ * ny_ + nz_ * nz_,
                                     1e-20))
    m_sph = jnp.take(mat_tab, sph_rows[..., 4].astype(jnp.int32),
                     axis=0)[:, None, :, :]               # (B, 1, K, 20)
    sr, sg, sb = _phong_terms(m_sph, scene.lights,
                              px, py, pz, nx_ * ninv, ny_ * ninv, nz_ * ninv,
                              dx[..., None], dy[..., None], dz[..., None])

    # planes: hard coverage (plane geometry is never a soft-fit trainable)
    pls = scene.planes
    t_pl_list, col_pl_list = [], []
    for i in range(pls.count):
        n_unit = _safe_normalize(pls.normal[i])
        nd = n_unit[0] * dx + n_unit[1] * dy + n_unit[2] * dz     # (B, P)
        no = n_unit[0] * ox + n_unit[1] * oy + n_unit[2] * oz
        off = pls.offset[i] * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(pls.normal[i] ** 2), 1e-20))
        t = (off - no) / jnp.where(jnp.abs(nd) < 1e-9,
                                   jnp.where(nd < 0, -1e-9, 1e-9), nd)
        hit = (jnp.abs(nd) > 1e-9) & (t > _T_EPS)
        t = jnp.clip(t, _T_EPS, t_bg)
        ppx, ppy, ppz = ox + t * dx, oy + t * dy, oz + t * dz
        sgn = jnp.where(nd > 0.0, -1.0, 1.0)
        m_pl = mat_tab[pls.material_id[i]]
        pr, pg, pb = _phong_terms(m_pl, scene.lights, ppx, ppy, ppz,
                                  sgn * n_unit[0], sgn * n_unit[1],
                                  sgn * n_unit[2], dx, dy, dz)
        t_pl_list.append(jnp.where(hit, t, t_bg))
        col_pl_list.append((jnp.where(hit, pr, 0.0),
                            jnp.where(hit, pg, 0.0),
                            jnp.where(hit, pb, 0.0),
                            hit.astype(t.dtype)))

    # --- softmax-over-depth aggregation, stabilized by the per-ray min t
    # over LIVE elements (alpha > 0); a dead sphere can sit nearer than
    # t_min, where the raw exponent is positive — the clamp zeroes exactly
    # (and only) those, so no 0 * exp(+inf) NaN and no approximation for
    # any live weight.
    t_eff = jnp.where(alpha > 0.0, t_sph, t_bg)
    t_min = jnp.min(t_eff, axis=-1)                       # (B, P)
    for t_pl in t_pl_list:
        t_min = jnp.minimum(t_min, t_pl)
    t_min = jnp.minimum(t_min, t_bg)

    w_sph = alpha * jnp.exp(
        jnp.minimum((t_min[..., None] - t_sph) / gamma, 0.0))
    den = jnp.sum(w_sph, axis=-1)
    num_r = jnp.sum(w_sph * sr, axis=-1)
    num_g = jnp.sum(w_sph * sg, axis=-1)
    num_b = jnp.sum(w_sph * sb, axis=-1)
    for t_pl, (pr, pg, pb, a_pl) in zip(t_pl_list, col_pl_list):
        w = a_pl * jnp.exp((t_min - t_pl) / gamma)
        den = den + w
        num_r = num_r + w * pr
        num_g = num_g + w * pg
        num_b = num_b + w * pb
    w_bg = jnp.exp((t_min - t_bg) / gamma)                # bg color = black
    den = den + w_bg
    inv = 1.0 / jnp.maximum(den, 1e-20)
    return jnp.stack([num_r * inv, num_g * inv, num_b * inv], axis=-1)


def soft_render_rays(scene: Scene, origins, dirs, *, bw: float, gamma: float,
                     cull=None, t_bg: float = 200.0, tile_block: int = 0,
                     with_cull_stats: bool = False):
    """Soft forward over flat rays. origins/dirs (R, 3), dirs unit.

    cull: None for a dense (R x N) pass, or ((th, tw) | tile_p, k) with
    tile-major rays (accel.tile_image order) for the coned broad phase.
    Returns (R, 3), plus the int32 overflow-event count when
    with_cull_stats (same never-silent contract as the culled engines)."""
    from openglraytracer_tpu.ops.accel import (_gather_tile_rows,
                                               _sphere_table, compact_mask,
                                               sphere_vs_cone, tile_cones)
    if scene.boxes.count:
        raise ValueError("soft forward supports spheres+planes only "
                         "(the graded fit configs); boxes have no "
                         "soft-coverage model")
    r = origins.shape[0]
    table = _sphere_table(scene)
    mat_tab = material_table(scene)
    ovf = jnp.zeros((), jnp.int32)

    if cull is None:
        o = origins[None]                                  # (1, R, 3)
        d = dirs[None]
        rows = table[None]                                 # (1, N, 6)
        valid = jnp.ones((1, table.shape[0]), bool)
        out = _composite_block(scene, mat_tab, o, d, rows, valid,
                               bw, gamma, t_bg)[0]
        return (out, ovf) if with_cull_stats else out

    tile, k = cull
    tile_p = tile[0] * tile[1] if isinstance(tile, tuple) else int(tile)
    assert r % tile_p == 0, "rays must be tile-major with tile_p | R"
    t_tiles = r // tile_p
    o_t = origins.reshape(t_tiles, tile_p, 3)
    d_t = dirs.reshape(t_tiles, tile_p, 3)
    axis, cos_half = tile_cones(d_t)
    mask = sphere_vs_cone(origins[0], axis, cos_half, scene.spheres.center,
                          scene.spheres.radius * expand_factor(bw))
    idx, valid, count = compact_mask(mask, k)
    ovf = jnp.sum(count > min(k, int(scene.spheres.count)),
                  dtype=jnp.int32)
    rows = _gather_tile_rows(table, idx)                   # (T, K, F)

    if tile_block <= 0:
        # bound the (B, P, K) working set near ~2^23 ray-sphere pairs
        tile_block = max(1, (8 << 20) // max(tile_p * idx.shape[1], 1))
        while t_tiles % tile_block:
            tile_block -= 1
    nb = t_tiles // tile_block

    # jax.checkpoint: without it the lax.map backward SAVES every block's
    # (B, P, K) shading/compositing intermediates — at c5 512^2 bw=0.5
    # that is ~20 x 352 MB of HLO temps, an instant OOM (measured r5).
    # Remat recomputes the block forward inside the backward instead: peak
    # memory drops to one block's working set at ~1.3x backward FLOPs.
    @jax.checkpoint
    def block(args):
        o_b, d_b, rows_b, valid_b = args
        return _composite_block(scene, mat_tab, o_b, d_b, rows_b, valid_b,
                                bw, gamma, t_bg)

    out = jax.lax.map(block, (
        o_t.reshape(nb, tile_block, tile_p, 3),
        d_t.reshape(nb, tile_block, tile_p, 3),
        rows.reshape(nb, tile_block, *rows.shape[1:]),
        valid.reshape(nb, tile_block, *valid.shape[1:])))
    out = out.reshape(r, 3)
    return (out, ovf) if with_cull_stats else out


@partial(jax.jit, static_argnums=(2, 3),
         static_argnames=("bw", "gamma", "cull", "t_bg", "with_cull_stats"))
def soft_render(scene: Scene, camera, height: int, width: int, *,
                bw: float = 0.05, gamma: float = 0.3, cull=None,
                t_bg: float = 200.0, with_cull_stats: bool = False):
    """Soft forward over the full image -> (H, W, 3) [, overflow events].

    With cull=((th, tw), k) rays are tiled through accel.tile_image and the
    result untiled back, mirroring the hard culled engines."""
    from openglraytracer_tpu.ops.accel import tile_image, untile_image
    from openglraytracer_tpu.ops.raygen import generate_rays
    origins, dirs = generate_rays(camera, height, width)
    if cull is None:
        o = origins.reshape(-1, 3)
        d = dirs.reshape(-1, 3)
        out = soft_render_rays(scene, o, d, bw=bw, gamma=gamma, cull=None,
                               t_bg=t_bg, with_cull_stats=with_cull_stats)
        img = (out[0] if with_cull_stats else out).reshape(height, width, 3)
        return (img, out[1]) if with_cull_stats else img
    (th, tw), k = cull
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    out = soft_render_rays(scene, o, d, bw=bw, gamma=gamma,
                           cull=((th, tw), k), t_bg=t_bg,
                           with_cull_stats=with_cull_stats)
    flat = out[0] if with_cull_stats else out
    img = untile_image(flat, height, width, th, tw)
    return (img, out[1]) if with_cull_stats else img
