"""Phong ADS shading with hard shadow rays.

Reimplements the reference's ads_phong_lighting (raytrace_compute.glsl:789-840)
as dense vectorized math over all rays at once, preserving its quirks:

  * The shadow ray direction is the *unnormalized* segment light_pos - p
    (:809) so an occluder strictly between surface and light shows up as a hit
    with t < 1 (:816). The shadow origin is offset by 0.01 * n (:808).
  * All four color channels accumulate; the returned RGB is
    ``phong.rgb * phong.a`` (:839) — alpha participates in shading.
  * Every light spawns a shadow ray, including the ambient-only "world light"
    whose position (0.1,0.1,0.1) still occludes diffuse/specular (:798-819).

Lights are iterated with a static Python loop (light counts are small and
static); each light's occlusion query is a normal-free any_hit pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openglraytracer_tpu.models.scene import Scene
from openglraytracer_tpu.ops.intersect import Hit, _safe_normalize, any_hit
from openglraytracer_tpu.ops.transforms import reflect

_POW_EPS = 1.0e-12
SHADOW_EPS = 0.01  # reference :808


def _safe_pow(base, exponent):
    """pow(max(base, 0), e) with gradients defined at base <= 0."""
    safe_base = jnp.maximum(base, _POW_EPS)
    val = jnp.exp(exponent * jnp.log(safe_base))
    return jnp.where(base > 0.0, val, 0.0)


def material_table(scene: Scene):
    """All 20 material columns packed into one (K, 20) table."""
    m = scene.materials
    return jnp.concatenate([
        m.ambient, m.diffuse, m.specular, m.emissive,
        m.shininess[:, None], m.reflectivity[:, None],
        m.transparency[:, None], m.refraction_index[:, None],
    ], axis=-1)


def materials_from_rows(scene: Scene, rows):
    """(R, 20) packed rows -> Materials-like namedtuple of (R, ...) arrays."""
    return scene.materials._replace(
        ambient=rows[..., 0:4],
        diffuse=rows[..., 4:8],
        specular=rows[..., 8:12],
        emissive=rows[..., 12:16],
        shininess=rows[..., 16],
        reflectivity=rows[..., 17],
        transparency=rows[..., 18],
        refraction_index=rows[..., 19],
    )


def gather_materials(scene: Scene, material_id):
    """Gather per-ray material rows. Returns a Materials-like namedtuple of
    (R, ...) arrays.

    The packed (K, 20) table is fetched with a single one-hot matmul
    (ops/gathers.py) instead of 8 separate gathers, and its transpose (the
    materials gradient) becomes a single one-hot scatter."""
    from openglraytracer_tpu.ops.gathers import gather_rows
    rows = gather_rows(material_table(scene), material_id)    # (R, 20)
    return materials_from_rows(scene, rows)


def static_shadow_mask(scene: Scene):
    """Which lights actually need shadow rays: a light with zero diffuse AND
    zero specular (the reference's ambient-only 'world light',
    raytrace_compute.glsl:199-206) cannot change the image when occluded —
    the ambient term is added regardless of shadowing (:822-836) — so its
    shadow casts are pure waste. Returns a static tuple of bools, or None if
    the light parameters are traced (unknown at trace time: cast them all).

    The reference spends 1/3 of its shadow rays on this light (SURVEY.md C14
    quirk note); skipping them is output-identical by construction.
    """
    import numpy as np
    diff, spec = scene.lights.diffuse, scene.lights.specular
    if isinstance(diff, jax.core.Tracer) or isinstance(spec, jax.core.Tracer):
        return None
    d = np.asarray(diff)
    s = np.asarray(spec)
    return tuple(bool(np.any(d[i] != 0.0) or np.any(s[i] != 0.0))
                 for i in range(scene.lights.count))


def static_bounce_mask(scene: Scene) -> tuple[bool, bool]:
    """(has_reflection, has_refraction): which bounce subtrees can contribute.

    The reference pushes a reflection child only when reflectivity > 0 and a
    refraction child only when transparency > 0 (raytrace_compute.glsl:979,
    :1001); when the concrete material table has max reflectivity == 0 (or
    max transparency == 0) that branch is statically dead for EVERY ray — the
    blend mix(mix(phong, refl, 0), refr, tau) reduces exactly (:1034-1054) —
    so tracing it is pure waste (a third of all casts in a depth-1 mirror
    scene). Output- and gradient-identical by construction: the `do_*` where
    gates already zero both the value and the cotangent at weight 0.

    Returns (True, True) when the material table is traced (unknown at trace
    time: keep both branches), mirroring static_shadow_mask.
    """
    import numpy as np
    refl, tau = scene.materials.reflectivity, scene.materials.transparency
    if isinstance(refl, jax.core.Tracer) or isinstance(tau, jax.core.Tracer):
        return (True, True)
    return (bool(np.any(np.asarray(refl) > 0.0)),
            bool(np.any(np.asarray(tau) > 0.0)))


def shadow_masks(scene: Scene, hit: Hit, chunk_size: int = 512,
                 remat: bool = False) -> jnp.ndarray:
    """Per-light occlusion masks, shape (R, L) bool (True = in shadow)."""
    shadow_org = hit.p + hit.n * SHADOW_EPS
    cols = []
    for j in range(scene.lights.count):
        to_light = scene.lights.position[j] - hit.p
        cols.append(any_hit(scene, shadow_org, to_light, max_t=1.0,
                            chunk_size=chunk_size, remat=remat))
    return jnp.stack(cols, axis=-1)


def phong_core(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """ADS Phong from raw arrays — the single source of the lighting math.
    mat_rows (R, 20) packed material rows
    (material_table layout); lpos/lamb/ldiff/lspec the (L, ...) light
    columns; occluded (R, L) bool. Returns (R, 3)."""
    ambient = jnp.zeros_like(mat_rows[..., 0:4])    # (R, 4)
    diffuse = jnp.zeros_like(ambient)
    specular = jnp.zeros_like(ambient)
    m_amb = mat_rows[..., 0:4]
    m_diff = mat_rows[..., 4:8]
    m_spec = mat_rows[..., 8:12]
    m_emis = mat_rows[..., 12:16]
    m_shin = mat_rows[..., 16]

    view_dir = _safe_normalize(-dirs)         # normalize(-r.dir) (:827)

    for j in range(lpos.shape[0]):
        ambient = ambient + lamb[j] * m_amb

        to_light = lpos[j] - p                # unnormalized segment (:809)
        light_dir = _safe_normalize(to_light)
        lit = (~occluded[:, j])[:, None].astype(dirs.dtype)

        light_ref = _safe_normalize(reflect(-light_dir, n))
        cos_theta = jnp.sum(light_dir * n, axis=-1, keepdims=True)
        cos_phi = jnp.sum(view_dir * light_ref, axis=-1, keepdims=True)

        diffuse = diffuse + lit * ldiff[j] * m_diff \
            * jnp.maximum(cos_theta, 0.0)
        specular = specular + lit * lspec[j] * m_spec \
            * _safe_pow(cos_phi, m_shin[:, None])

    phong = ambient + diffuse + specular + m_emis
    return phong[..., :3] * phong[..., 3:4]   # rgb * alpha (:839)


def phong_shade_lit(scene: Scene, dirs, hit: Hit, occluded,
                    mat_rows=None) -> jnp.ndarray:
    """ADS Phong given precomputed occlusion masks occluded (R, L) —
    the lighting math with the shadow queries factored out so the Pallas
    geometry engine can supply them. Returns (R, 3).

    mat_rows: optional precomputed (R, 20) packed material rows (the culled
    engine supplies them via its tile survivor lists, skipping the slow
    global per-ray gather for large material tables)."""
    if mat_rows is None:
        from openglraytracer_tpu.ops.gathers import gather_rows
        mat_rows = gather_rows(material_table(scene), hit.material_id)
    lights = scene.lights
    return phong_core(mat_rows, lights.position, lights.ambient,
                      lights.diffuse, lights.specular, dirs, hit.p, hit.n,
                      occluded)


def phong_shade(scene: Scene, dirs, hit: Hit, chunk_size: int = 512,
                remat: bool = False) -> jnp.ndarray:
    """ADS Phong color for each ray's hit (shadow queries included).
    dirs: (R, 3) incident ray dirs (normalized). Returns (R, 3);
    garbage-but-finite on misses (caller masks)."""
    occluded = shadow_masks(scene, hit, chunk_size=chunk_size, remat=remat)
    return phong_shade_lit(scene, dirs, hit, occluded)
