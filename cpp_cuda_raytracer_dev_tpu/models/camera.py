"""Pinhole camera model + ray generation as pure, differentiable JAX.

Replaces the reference's ``Camera`` class (``TEST_Dungeonrun/Camera.h/.cpp``)
and its ray-gen kernel ``init_cam_mem_cuda`` (``Camera.cu:89-111``). The
reference allocates ~17 mutable per-pixel device arrays up front
(Camera.cpp:73-108); here ray generation is a pure function of the camera
parameters, so "camera state" is just this pytree and the per-pixel buffers
(`RayBuffers`) are recomputed/fused by XLA each frame — and the whole thing is
differentiable w.r.t. position/look-at/up/focal length for free.

Conventions (matching Camera.cpp:32-67):
  n = normalize(look_at - pos)            # view direction
  v = normalize(n x (up x n))             # screen-up
  u = v x n                               # screen-right
  pixel pitch = film / resolution, s = focal / pitch
  ray(ix, iy) = normalize(n + u*(ix - adjust_x)/s_x + v*(iy - adjust_y)/s_y)
with adjust = res//2, minus half a pixel when the resolution is even
(Camera.cpp:61-63) — the reference's n_mod + u_mod*ix + v_mod*iy divided by
focal. Row iy=0 is the *bottom* of the image (bottom-up DIB,
WinMain.cpp:217). Every primary ray, for shading, the oracle and the bin
kernel alike, comes from `Projection.pixel_rays`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import vecmath
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class Projection:
    """World-point -> subpixel-coordinate map (the inverse of ray gen):
    ix = adjust_x + sx·((p-origin)·u)/((p-origin)·n), iy likewise with
    (v, sy). Rotate (n, u, v) and origin into an object's frame with
    `transformed` to project object-space geometry directly."""

    origin: jax.Array   # (3,)
    n: jax.Array        # (3,) view direction (unit)
    u: jax.Array        # (3,) screen-right (unit)
    v: jax.Array        # (3,) screen-up (unit)
    sx: jax.Array       # scalar focal/pix_w
    sy: jax.Array       # scalar focal/pix_h
    adjust_x: jax.Array  # scalar pixel-center offset
    adjust_y: jax.Array

    def pixel_rays(self, ix: jax.Array, iy: jax.Array):
        """Unit primary-ray directions through pixels (ix, iy) as three
        component arrays: normalize(n + u·(ix-adjust_x)/sx +
        v·(iy-adjust_y)/sy), ray(ix, iy) of Camera.cu:103-104. Offsets from
        the principal point are exact (integers and halves), so a band
        rendered with a shifted adjust_y gets bit-identical directions to
        the same pixels of the full frame."""
        fx = ix - self.adjust_x
        fy = iy - self.adjust_y
        um = self.u / self.sx
        vm = self.v / self.sy
        dc = [self.n[a] + um[a] * fx + vm[a] * fy for a in range(3)]
        inv = jax.lax.rsqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2])
        return dc[0] * inv, dc[1] * inv, dc[2] * inv

    def transformed(self, pose) -> "Projection":
        """This projection expressed in an object's local frame (the
        pose-on-the-ray trick, Trixel.cu:60-66, applied to the cull)."""
        return self.replace(origin=pose.inv_apply(self.origin),
                            n=pose.inv_apply_vec(self.n),
                            u=pose.inv_apply_vec(self.u),
                            v=pose.inv_apply_vec(self.v))


@pytree_dataclass
class Camera:
    pos: jax.Array        # (3,)
    look_at: jax.Array    # (3,)
    up: jax.Array         # (3,)
    film_w: jax.Array     # scalar — film width in meters (.024 * aspect)
    film_h: jax.Array     # scalar
    focal: jax.Array      # scalar — focal length (.055 in WinMain.cpp:70)
    res_w: int = static_field(default=960)
    res_h: int = static_field(default=540)

    @classmethod
    def create(cls, res_w: int, res_h: int, pos, look_at, up,
               film_h: float = 0.024, focal: float = 0.055,
               film_w: float | None = None, dtype=jnp.float32) -> "Camera":
        """Reference construction (WinMain.cpp:69-74): film_w = aspect*0.024.

        ``dtype``: runtime precision switch (typedefs.h PPP_TAG analogue);
        ray directions inherit it."""
        if film_w is None:
            film_w = film_h * (res_w / res_h)
        fp = lambda x: jnp.asarray(x, dtype)
        return cls(pos=fp(pos), look_at=fp(look_at), up=fp(up),
                   film_w=fp(film_w), film_h=fp(film_h), focal=fp(focal),
                   res_w=res_w, res_h=res_h)

    @property
    def num_pixels(self) -> int:
        return self.res_w * self.res_h

    def pixel_pitch(self) -> tuple[jax.Array, jax.Array]:
        return self.film_w / self.res_w, self.film_h / self.res_h

    def basis(self) -> tuple[jax.Array, jax.Array, jax.Array]:
        """(n, u, v) orthonormal basis per Camera.cpp:32-58."""
        n = vecmath.normalize(self.look_at - self.pos)
        up = vecmath.normalize(self.up)
        v = vecmath.normalize(vecmath.cross(n, vecmath.cross(up, n)))
        u = vecmath.cross(v, n)
        return n, u, v

    def projection(self) -> "Projection":
        """Inverse of ray generation: the constants that map a world point
        to its (sub)pixel coordinates. A point p with camera-basis
        components a = (p-pos)·n, b = ·u, c = ·v projects to
        ix = adjust_x + (b/a)·focal/pix_w (iy likewise) — the exact inverse
        of ray(ix, iy) = focal·n + pix_w(ix-adjust_x)·u + pix_h(iy-adjust_y)·v
        (Camera.cpp:61-67). Used by ray generation (`Projection.pixel_rays`)
        and the screen-space binning cull (accel/binning.py)."""
        n, u, v = self.basis()
        pix_w, pix_h = self.pixel_pitch()
        adjust_x = self.res_w // 2 - (0.5 if self.res_w % 2 == 0 else 0.0)
        adjust_y = self.res_h // 2 - (0.5 if self.res_h % 2 == 0 else 0.0)
        return Projection(origin=self.pos, n=n, u=u, v=v,
                          sx=self.focal / pix_w, sy=self.focal / pix_h,
                          adjust_x=jnp.asarray(adjust_x, self.pos.dtype),
                          adjust_y=jnp.asarray(adjust_y, self.pos.dtype))

    def ray_directions(self) -> jax.Array:
        """All primary ray directions, flat (H*W, 3), row iy=0 = bottom.

        Pixel index i maps to (ix, iy) = (i % W, i // W) exactly like the
        1-thread-per-pixel kernel (Camera.cu:94-95,103-104); the directions
        are `Projection.pixel_rays`, as flat (R,) components stacked once.
        """
        r = self.res_h * self.res_w
        i = jnp.arange(r, dtype=jnp.int32)
        ix = (i % self.res_w).astype(self.pos.dtype)
        iy = (i // self.res_w).astype(self.pos.dtype)
        return jnp.stack(self.projection().pixel_rays(ix, iy), axis=-1)


@pytree_dataclass
class RayBuffers:
    """Per-pixel ray state — the analogue of ``Camera::pixel_memory``
    (Camera.h:15-97, filled by Camera.cu:89-111), as an immutable pytree."""

    rmd: jax.Array        # (N, 3) unit ray directions
    inv_rmd: jax.Array    # (N, 3) 1/rmd (Camera.cu:106)
    sign_rmd: jax.Array   # (N, 3) int32 sign bits (Camera.cu:107)
    dist: jax.Array       # (N,) hit distance, init draw_distance
    rmi: jax.Array        # (N,) int32 hit triangle index, init -1

    @classmethod
    def create(cls, camera: Camera, draw_distance: float = 400.0
               ) -> "RayBuffers":
        rmd = camera.ray_directions()
        n = rmd.shape[0]
        return cls(
            rmd=rmd,
            inv_rmd=1.0 / rmd,
            sign_rmd=vecmath.sign_bits(rmd),
            dist=jnp.full((n,), draw_distance, rmd.dtype),
            rmi=jnp.full((n,), -1, jnp.int32),
        )
