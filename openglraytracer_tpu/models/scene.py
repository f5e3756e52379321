"""Scene schema: structure-of-arrays pytrees for a differentiable raytracer.

The reference hardcodes the scene as GLSL global initializers — an array of 5
``Object`` structs each holding a tagged union of Box/Sphere plus an inline
``Material`` (reference raytrace_compute.glsl:56-157 materials, :162-179
box/sphere defs, :190-224 lights, :244-321 objects).  This design
replaces that array-of-structs with structure-of-arrays device arrays so every
intersection/shading op is a dense, branch-free, vmappable computation:

  * ``Spheres``:  center (N,3), radius (N,), material id (N,)
  * ``Boxes``:    mins/maxs (M,3) in local space, position (M,3),
                  euler angles in degrees (M,3), material id (M,)
  * ``Planes``:   infinite planes  dot(normal, x) = offset  (the analytic
                  "ground plane" the benchmark configs use; the reference has
                  no plane primitive — its floor is a thin OBB)
  * ``Materials``: one row per material; objects reference rows by id, so a
                  material can be shared (reference inlines a full Material
                  copy per object) or unique-per-object for inverse rendering.
  * ``Lights``:   point lights with vec4 ambient/diffuse/specular colors.

All color fields keep the reference's 4 components because its Phong output is
``phong_color.rgb * phong_color.a`` (raytrace_compute.glsl:839) — the alpha
channels of material and light colors participate in shading.

Everything is a NamedTuple => automatically a JAX pytree: scenes can be
jit arguments, donated, sharded, and differentiated against directly.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# The reference treats any hit with t >= 10000 as a miss
# (raytrace_compute.glsl:740 `float closest = 10000`).
MISS_T = 10000.0
# Index of refraction of open space (raytrace_compute.glsl:72).
AIR_IOR = 1.0
# Global time scale applied to scene/camera animation (raytrace_compute.glsl:236).
TIME_SCALE = 0.4


class Materials(NamedTuple):
    """Phong + raytracing material table (reference Material struct, :56-69)."""

    ambient: jnp.ndarray        # (K, 4)
    diffuse: jnp.ndarray        # (K, 4)
    specular: jnp.ndarray       # (K, 4)
    shininess: jnp.ndarray      # (K,)
    emissive: jnp.ndarray       # (K, 4)
    reflectivity: jnp.ndarray   # (K,)  strength of the reflected ray's color
    transparency: jnp.ndarray   # (K,)  strength of the refracted ray's color
    refraction_index: jnp.ndarray  # (K,)

    @property
    def count(self) -> int:
        return self.shininess.shape[-1]


class Lights(NamedTuple):
    """Point lights (reference Light struct, :190-196)."""

    position: jnp.ndarray   # (L, 3)
    ambient: jnp.ndarray    # (L, 4)
    diffuse: jnp.ndarray    # (L, 4)
    specular: jnp.ndarray   # (L, 4)

    @property
    def count(self) -> int:
        return self.position.shape[-2]


class Spheres(NamedTuple):
    center: jnp.ndarray       # (N, 3)
    radius: jnp.ndarray       # (N,)
    material_id: jnp.ndarray  # (N,) int32

    @property
    def count(self) -> int:
        return self.radius.shape[-1]


class Boxes(NamedTuple):
    """Oriented boxes: local-space AABB + position + euler angles (degrees).

    Matches the reference Object{Box, position, angles} (raytrace_compute.glsl:
    166-170, 244-258): the box is an AABB in its local frame, placed by
    translation(position) @ rotation(angles).
    """

    mins: jnp.ndarray         # (M, 3)
    maxs: jnp.ndarray         # (M, 3)
    position: jnp.ndarray     # (M, 3)
    angles: jnp.ndarray       # (M, 3) pitch/yaw/roll degrees
    material_id: jnp.ndarray  # (M,) int32

    @property
    def count(self) -> int:
        return self.material_id.shape[-1]


class Planes(NamedTuple):
    """Infinite planes dot(normal, x) = offset. Not in the reference; the
    analytic primitive the benchmark configs ("sphere + ground plane") use."""

    normal: jnp.ndarray       # (P, 3) need not be unit length
    offset: jnp.ndarray       # (P,)
    material_id: jnp.ndarray  # (P,) int32

    @property
    def count(self) -> int:
        return self.offset.shape[-1]


class Scene(NamedTuple):
    spheres: Spheres
    boxes: Boxes
    planes: Planes
    materials: Materials
    lights: Lights

    @property
    def object_count(self) -> int:
        return self.spheres.count + self.boxes.count + self.planes.count


class Camera(NamedTuple):
    """Reference Camera struct (raytrace_compute.glsl:36-50)."""

    position: jnp.ndarray  # (3,)
    angles: jnp.ndarray    # (3,) pitch/yaw/roll in degrees
    v_fov: jnp.ndarray     # scalar, vertical fov degrees
    aspect: jnp.ndarray    # scalar, width / height
    near: jnp.ndarray      # scalar
    far: jnp.ndarray       # scalar


def make_camera(position, angles=(0.0, 0.0, 0.0), v_fov=90.0,
                aspect=16.0 / 9.0, near=0.1, far=1000.0,
                dtype=jnp.float32) -> Camera:
    return Camera(
        position=jnp.asarray(position, dtype),
        angles=jnp.asarray(angles, dtype),
        v_fov=jnp.asarray(v_fov, dtype),
        aspect=jnp.asarray(aspect, dtype),
        near=jnp.asarray(near, dtype),
        far=jnp.asarray(far, dtype),
    )


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _stack_vec4(rows, dtype):
    out = np.zeros((len(rows), 4), np.float64)
    for i, r in enumerate(rows):
        r = np.atleast_1d(np.asarray(r, np.float64))
        out[i] = r if r.shape == (4,) else np.full(4, r[0]) if r.shape == (1,) else np.concatenate([r, [1.0]])
    return jnp.asarray(out, dtype)


def make_materials(rows, dtype=jnp.float32) -> Materials:
    """rows: list of dicts with keys ambient, diffuse, specular, shininess,
    emissive, reflectivity, transparency, refraction_index. Scalar color
    values broadcast to all 4 channels (GLSL vec4(x) semantics)."""
    def vec4(key, default):
        return _stack_vec4([r.get(key, default) for r in rows], dtype)

    def scalar(key, default):
        return jnp.asarray([float(r.get(key, default)) for r in rows], dtype)

    return Materials(
        ambient=vec4("ambient", 1.0),
        diffuse=vec4("diffuse", 1.0),
        specular=vec4("specular", 1.0),
        shininess=scalar("shininess", 1.0),
        emissive=vec4("emissive", 0.0),
        reflectivity=scalar("reflectivity", 0.0),
        transparency=scalar("transparency", 0.0),
        refraction_index=scalar("refraction_index", 1.0),
    )


def make_lights(rows, dtype=jnp.float32) -> Lights:
    return Lights(
        position=jnp.asarray([r["position"] for r in rows], dtype),
        ambient=_stack_vec4([r.get("ambient", 0.0) for r in rows], dtype),
        diffuse=_stack_vec4([r.get("diffuse", 0.0) for r in rows], dtype),
        specular=_stack_vec4([r.get("specular", 0.0) for r in rows], dtype),
    )


def empty_spheres(dtype=jnp.float32) -> Spheres:
    return Spheres(jnp.zeros((0, 3), dtype), jnp.zeros((0,), dtype),
                   jnp.zeros((0,), jnp.int32))


def empty_boxes(dtype=jnp.float32) -> Boxes:
    z3 = jnp.zeros((0, 3), dtype)
    return Boxes(z3, z3, z3, z3, jnp.zeros((0,), jnp.int32))


def empty_planes(dtype=jnp.float32) -> Planes:
    return Planes(jnp.zeros((0, 3), dtype), jnp.zeros((0,), dtype),
                  jnp.zeros((0,), jnp.int32))


def make_scene(spheres=None, boxes=None, planes=None, materials=None,
               lights=None) -> Scene:
    if materials is None or lights is None:
        raise ValueError("materials and lights are required")
    return Scene(
        spheres=spheres if spheres is not None else empty_spheres(),
        boxes=boxes if boxes is not None else empty_boxes(),
        planes=planes if planes is not None else empty_planes(),
        materials=materials,
        lights=lights,
    )


# ---------------------------------------------------------------------------
# Reference material/light constants (raytrace_compute.glsl:74-224), kept as
# plain data so port-fidelity scenes can be assembled from them.
# ---------------------------------------------------------------------------

REF_MATERIALS = {
    # name -> dict; order of fields mirrors the GLSL Material initializers
    "material1": dict(ambient=1.0, diffuse=(0.5, 0.0, 0.0, 1.0), specular=1.0,
                      shininess=4.0, emissive=0.0, reflectivity=1.0,
                      transparency=0.0, refraction_index=1.5),
    "material2": dict(ambient=1.0, diffuse=(0.3, 0.6, 0.3, 1.0), specular=1.0,
                      shininess=4.0, emissive=0.0, reflectivity=1.0,
                      transparency=0.0, refraction_index=1.5),
    "red_glass": dict(ambient=1.0, diffuse=(1.0, 0.0, 0.0, 1.0), specular=1.0,
                      shininess=10.0, emissive=0.0, reflectivity=0.8,
                      transparency=0.4, refraction_index=1.5),
    "green_glass": dict(ambient=1.0, diffuse=(0.0, 1.0, 0.0, 1.0), specular=1.0,
                        shininess=10.0, emissive=0.0, reflectivity=0.4,
                        transparency=0.6, refraction_index=1.5),
    "blue_glass": dict(ambient=1.0, diffuse=(0.0, 0.0, 1.0, 1.0), specular=1.0,
                       shininess=10.0, emissive=0.0, reflectivity=0.4,
                       transparency=0.6, refraction_index=1.5),
    "mirror": dict(ambient=1.0, diffuse=(0.6, 0.6, 0.6, 1.0), specular=1.0,
                   shininess=4.0, emissive=0.0, reflectivity=1.0,
                   transparency=0.0, refraction_index=1.0),
    "wall": dict(ambient=0.5, diffuse=0.4, specular=0.3, shininess=3.0,
                 emissive=0.0, reflectivity=0.3, transparency=0.0,
                 refraction_index=1.0),
}

REF_LIGHTS = [
    # World ambient light (position still spawns shadow rays in the reference)
    dict(position=(0.1, 0.1, 0.1), ambient=0.3, diffuse=0.0, specular=0.0),
    # Point Light #1 (white)
    dict(position=(7.0, 7.0, 2.0), ambient=0.05, diffuse=1.0, specular=1.0),
    # Point Light #2 (red)
    dict(position=(3.0, -3.0, 4.0), ambient=0.05,
         diffuse=(1.0, 0.0, 0.0, 1.0), specular=(1.0, 0.0, 0.0, 1.0)),
]


# ---------------------------------------------------------------------------
# JSON scene IO — "scenes as data, not code" (the deliberate API divergence
# from the reference's compile-the-scene-into-the-shader model; SURVEY.md §5
# config system).
# ---------------------------------------------------------------------------

def scene_to_dict(scene: Scene) -> dict:
    def arr(x):
        return np.asarray(x).tolist()
    return {
        "spheres": {k: arr(v) for k, v in scene.spheres._asdict().items()},
        "boxes": {k: arr(v) for k, v in scene.boxes._asdict().items()},
        "planes": {k: arr(v) for k, v in scene.planes._asdict().items()},
        "materials": {k: arr(v) for k, v in scene.materials._asdict().items()},
        "lights": {k: arr(v) for k, v in scene.lights._asdict().items()},
    }


def scene_from_dict(d: dict, dtype=jnp.float32) -> Scene:
    # trailing dims of each 2-D column (everything else is 1-D)
    vec_cols = {"center": 3, "mins": 3, "maxs": 3, "position": 3, "angles": 3,
                "normal": 3, "ambient": 4, "diffuse": 4, "specular": 4,
                "emissive": 4}

    def load(cls, key, int_keys=("material_id",)):
        sub = d.get(key)
        if sub is None:
            sub = {f: (np.zeros((0, vec_cols[f])) if f in vec_cols
                       else np.zeros((0,))) for f in cls._fields}
        if not isinstance(sub, dict):
            raise ValueError(
                f"scene JSON: '{key}' must be a dict of column arrays "
                f"(fields: {list(cls._fields)}), got {type(sub).__name__}; "
                f"see scene_to_dict / save_scene for the schema")
        missing = set(cls._fields) - set(sub)
        if missing:
            raise ValueError(
                f"scene JSON: '{key}' is missing columns {sorted(missing)}")
        kw = {}
        for k, v in sub.items():
            kw[k] = jnp.asarray(v, jnp.int32 if k in int_keys else dtype)
        return cls(**kw)

    return Scene(
        spheres=load(Spheres, "spheres"),
        boxes=load(Boxes, "boxes"),
        planes=load(Planes, "planes"),
        materials=load(Materials, "materials", int_keys=()),
        lights=load(Lights, "lights", int_keys=()),
    )


def camera_to_dict(camera: Camera) -> dict:
    return {k: np.asarray(v).tolist() for k, v in camera._asdict().items()}


def camera_from_dict(d: dict, dtype=jnp.float32) -> Camera:
    missing = set(Camera._fields) - set(d)
    if missing:
        raise ValueError(f"scene JSON: 'camera' is missing {sorted(missing)}")
    return Camera(**{k: jnp.asarray(d[k], dtype) for k in Camera._fields})


def save_scene(scene: Scene, path: str, camera: Camera | None = None) -> None:
    """Save scene (+ optionally its camera) as JSON. The reference treats
    scene and camera as one unit compiled into the shader
    (raytrace_compute.glsl:36-50, :332-367); passing ``camera`` keeps that
    unit in the data file."""
    d = scene_to_dict(scene)
    if camera is not None:
        d["camera"] = camera_to_dict(camera)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def load_scene(path: str, dtype=jnp.float32) -> Scene:
    with open(path) as f:
        return scene_from_dict(json.load(f), dtype)


def load_scene_camera(path: str, dtype=jnp.float32):
    """(Scene, Camera | None) from a scene JSON; None when the file has no
    'camera' entry (camera then comes from CLI flags / defaults)."""
    with open(path) as f:
        d = json.load(f)
    cam = camera_from_dict(d["camera"], dtype) if "camera" in d else None
    return scene_from_dict(d, dtype), cam
