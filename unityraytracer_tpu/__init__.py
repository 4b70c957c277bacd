"""unityraytracer_tpu: a progressive Monte-Carlo path tracer for GPUs.

Built in JAX/XLA with a Pallas (Triton) closest-hit kernel, with the
capabilities of the reference Unity compute-shader ray tracer
(RemyMuj/UnityRayTracer): sphere / mesh /
ground-plane scenes, albedo-specular-emissive roulette BRDF, Moller-Trumbore
triangles with barycentric smooth normals, LBVH acceleration, HDRI equirect
skyboxes, progressive accumulation, and multi-device framebuffer sharding.
"""

from .config import RenderConfig
from .camera import Camera, camera_rays
from .scene import (Material, Materials, Scene, SceneBuilder, Spheres,
                    Triangles, compute_smooth_normals, GROUND_MATERIAL)
from .render import Renderer, RenderState, render_sample, progressive_step

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "Camera", "camera_rays", "Material", "Materials", "Scene",
    "SceneBuilder", "Spheres", "Triangles", "compute_smooth_normals",
    "GROUND_MATERIAL", "Renderer", "RenderState", "render_sample",
    "progressive_step",
]
