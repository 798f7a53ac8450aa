"""Scene data model: triangle soup, objects with poses, materials, lights.

Replaces the reference's ``Trixel``/``Object``/``Color`` triple
(``TEST_Dungeonrun/Trixel.h:39-133``, ``Object.h``, ``Color.h``) with
immutable pytrees of batched arrays:

- `Triangles` is the SoA the reference builds on-device in
  ``init_tri_mem_cuda`` (Trixel.cu:11-27): first vertex p1, edges e1=p2-p1,
  e2=p3-p1, unit normal n = normalize(e1 x e2), plus per-triangle radiance
  color. Here the precompute is one fused jnp expression.
- `SceneObject` binds geometry + a `Pose` (Object.h:4-17 binds Trixel* +
  Quaternion). Geometry never moves: the pose is applied to rays at render
  time (the reference's pose-on-the-ray trick, Trixel.cu:60-66), so pose
  updates are O(1) and differentiation w.r.t. pose flows only through the
  ray transform.
- `PhongParams` promotes the shading constants hardcoded in the kernel
  (light at (2,2,2), 0.6 diffuse, 0.3 spec, exponent 5 — Camera.cu:32,44-45)
  to learnable parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import vecmath
from ..ops.quaternion import Pose
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class Triangles:
    """Triangle soup, STORED as flat (T,) component arrays.

    The per-frame binning prepass reads all nine p1/e1/e2 components as
    dense (T,) arrays, so components are the stored pytree leaves (they
    are also the differentiable parameters — gradients flow to them
    through the (T, 3) views, which are PROPERTIES built on demand for
    API/oracle/host consumers)."""

    p1x: jax.Array     # (T,) first-vertex / edge components
    p1y: jax.Array
    p1z: jax.Array
    e1x: jax.Array     # e1 = p2 - p1
    e1y: jax.Array
    e1z: jax.Array
    e2x: jax.Array     # e2 = p3 - p1
    e2y: jax.Array
    e2z: jax.Array
    color: jax.Array   # (T, 3) per-triangle radiance rgb (shading-only:
                       # consumed via the packed row-gather table, never
                       # column-sliced in a hot loop)

    @classmethod
    def from_vertices(cls, tri_vertices, color=None,
                      dtype=jnp.float32) -> "Triangles":
        """Build from (T, 3, 3) vertex blocks; the analogue of
        init_tri_mem_cuda (Trixel.cu:11-27). Default color matches the
        scene setup at WinMain.cpp:118-120: (0.1, 0.55, 0.20).

        ``dtype`` is the runtime analogue of the reference's compile-time
        precision switch (typedefs.h:11-29 PPP_TAG -> T_fp float/double):
        the scene's dtype flows through every downstream op. float64
        requires jax_enable_x64; the "brute"/"fixed"/"kd" intersect paths
        run fully in the scene dtype, while the cluster and bin paths store
        acceleration geometry in f32."""
        tv = jnp.asarray(tri_vertices, dtype)
        p1 = tv[:, 0]
        e1 = tv[:, 1] - p1
        e2 = tv[:, 2] - p1
        if color is None:
            color = jnp.broadcast_to(
                jnp.array([0.1, 0.55, 0.20], dtype), p1.shape)
        else:
            color = jnp.broadcast_to(
                jnp.asarray(color, dtype), p1.shape)
        return cls(p1x=p1[:, 0], p1y=p1[:, 1], p1z=p1[:, 2],
                   e1x=e1[:, 0], e1y=e1[:, 1], e1z=e1[:, 2],
                   e2x=e2[:, 0], e2y=e2[:, 1], e2z=e2[:, 2],
                   color=color)

    # (T, 3) views for oracle/host/test consumers (one padded
    # materialization each — do NOT column-slice these in per-frame code;
    # use the flat fields)
    @property
    def p1(self) -> jax.Array:
        return jnp.stack([self.p1x, self.p1y, self.p1z], axis=-1)

    @property
    def e1(self) -> jax.Array:
        return jnp.stack([self.e1x, self.e1y, self.e1z], axis=-1)

    @property
    def e2(self) -> jax.Array:
        return jnp.stack([self.e2x, self.e2y, self.e2z], axis=-1)

    @property
    def n(self) -> jax.Array:
        """Unit geometric normal normalize(e1 x e2), derived on demand, so
        gradients flow through the true n(e1, e2) dependence."""
        cnx = self.e1y * self.e2z - self.e1z * self.e2y
        cny = self.e1z * self.e2x - self.e1x * self.e2z
        cnz = self.e1x * self.e2y - self.e1y * self.e2x
        inv = jax.lax.rsqrt(jnp.maximum(
            cnx * cnx + cny * cny + cnz * cnz, 1e-30))
        return jnp.stack([cnx * inv, cny * inv, cnz * inv], axis=-1)

    @property
    def num_triangles(self) -> int:
        return self.p1x.shape[0]

    def vertices(self) -> jax.Array:
        """Back to (T, 3, 3) vertex blocks (p1, p2, p3)."""
        return jnp.stack([self.p1, self.p1 + self.e1, self.p1 + self.e2],
                         axis=1)

    def aabbs(self) -> tuple[jax.Array, jax.Array]:
        v = self.vertices()
        return v.min(axis=1), v.max(axis=1)

    def centroid(self) -> jax.Array:
        """Mid-point of the overall AABB — the reference's ``zero_offset``
        (Trixel.h:468-471)."""
        lo, hi = self.aabbs()
        return (lo.min(axis=0) + hi.max(axis=0)) / 2.0


@pytree_dataclass
class SceneObject:
    """Geometry + pose. Multiple objects may share geometry (the reference
    creates two Objects over one Trixel list, WinMain.cpp:152-156)."""

    tris: Triangles
    pose: Pose

    @classmethod
    def create(cls, tris: Triangles, pose: Pose | None = None
               ) -> "SceneObject":
        return cls(tris=tris, pose=pose if pose is not None
                   else Pose.identity(tris.p1.dtype))


@pytree_dataclass
class PhongParams:
    """Learnable Phong/lighting parameters (kernel literals in
    Camera.cu:32,44-52 promoted to parameters)."""

    light_pos: jax.Array     # (3,) — reference: (2, 2, 2)
    light_color: jax.Array   # (3,) — reference: implicit 1
    diffuse: jax.Array       # scalar — reference: 0.6
    specular: jax.Array      # scalar — reference: 0.3
    exponent: jax.Array      # scalar — reference: 5

    @classmethod
    def reference(cls, dtype=jnp.float32) -> "PhongParams":
        fp = lambda x: jnp.asarray(x, dtype)
        return cls(light_pos=fp([2.0, 2.0, 2.0]),
                   light_color=fp([1.0, 1.0, 1.0]),
                   diffuse=fp(0.6), specular=fp(0.3), exponent=fp(5.0))


@pytree_dataclass
class Scene:
    """A renderable scene: objects + lighting parameters."""

    objects: tuple[SceneObject, ...]
    phong: PhongParams

    @classmethod
    def create(cls, objects, phong: PhongParams | None = None) -> "Scene":
        objects = tuple(objects)
        if phong is None:
            dtype = (objects[0].tris.p1.dtype if objects
                     else jnp.float32)
            phong = PhongParams.reference(dtype)
        return cls(objects=objects, phong=phong)


def default_colors(num_tri: int) -> np.ndarray:
    """Per-triangle color init used by the reference scene
    (WinMain.cpp:117-121)."""
    return np.broadcast_to(
        np.array([0.1, 0.55, 0.20], np.float32), (num_tri, 3)).copy()
