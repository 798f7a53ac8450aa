"""Differentiable ray tracing framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capability surface of the CUDA
renderer ``ams3878/cpp_cuda_raytracer_dev`` (see SURVEY.md): PLY mesh
loading, Möller–Trumbore intersection, KD-tree spatial hierarchy, Phong
shading, quaternion camera/object animation — as pure jit-compiled
functions, differentiable end-to-end, sharded over device meshes.
"""

from .io.ply import MeshData, load_mesh, read_ply
from .models.camera import Camera, RayBuffers
from .models.renderer import RenderOutput, render, render_jit
from .models.scene import (PhongParams, Scene, SceneObject, Triangles,
                           default_colors)
from .ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from .ops.quaternion import Pose
from .utils.config import RenderConfig

__version__ = "0.1.0"

__all__ = [
    "Camera", "FixedOriginCache", "Hit", "MeshData", "PhongParams",
    "Pose", "RayBuffers", "RenderConfig", "RenderOutput", "Scene",
    "SceneObject", "Triangles", "default_colors", "load_mesh",
    "mt_brute", "mt_fixed_origin", "read_ply", "render", "render_jit",
]
