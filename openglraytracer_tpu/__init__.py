"""openglraytracer_tpu — a differentiable raytracer in JAX.

A from-scratch JAX/XLA/Pallas reimagining of the capabilities of the reference
OpenGL compute-shader raytracer (blubs/OpenGLRaytracer): camera ray generation,
ray-sphere / ray-OBB / ray-plane intersection, Phong ADS shading with hard
shadow rays, and bounded reflection/refraction recursion — rebuilt as pure,
jittable, differentiable functions over structure-of-arrays scene pytrees,
tile-sharded over device meshes (one or more GPUs).

Reference layer map (see SURVEY.md §1):
  L3 GLSL kernel  -> ops/ (XLA render path) + ops/pallas_culled.py (Triton kernels)
  L2 C++ host     -> render/driver functions + cli.py
  L4 blit         -> utils/image.py host-side gather + PNG output
  L1 GL utilities -> the JAX/XLA toolchain itself
"""

__version__ = "0.1.0"

from openglraytracer_tpu.models.scene import (  # noqa: F401
    Camera,
    Lights,
    Materials,
    Planes,
    Boxes,
    Spheres,
    Scene,
)
from openglraytracer_tpu.ops.render import render, trace_rays  # noqa: F401
