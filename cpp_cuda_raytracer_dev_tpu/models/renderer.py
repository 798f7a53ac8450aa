"""The renderer: ray gen -> per-object intersect -> nearest combine -> shade.

This is the frame loop body of the reference (``WinMain.cpp:212-237``:
``obj->render`` -> ``intersect_voxel_cuda`` then ``color_pixels`` ->
``color_cam_cuda``) re-designed as one pure jit-compiled function.

Structure: the core (`render_rays`) operates on a flat batch of rays with
explicit band dimensions, so the same function runs single-chip or inside
``shard_map`` over image-row bands (parallel/render_pjit.py). `render` is
the single-chip convenience wrapper that adds ray gen + image reshape.

Differentiability design (SURVEY.md §7 step 5): nearest-hit *selection*
(triangle indices) is discrete and wrapped in ``stop_gradient``; the shading
path then *re-derives* the hit distance differentiably from the selected
triangle's geometry, so gradients flow w.r.t. vertices, poses, camera, and
Phong/light parameters at fixed topology — matching the "grad allclose vs
FD" acceptance bar (BASELINE.json). Backward cost is O(rays), not
O(rays x tris): only the selected triangle is re-intersected.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.intersect import FixedOriginCache, Hit, mt_brute, mt_fixed_origin
from ..utils.config import RenderConfig
from ..utils.pytree import pytree_dataclass
from .camera import Camera
from .scene import Scene


@pytree_dataclass
class RenderOutput:
    """Frame outputs. ``image`` is the uint8 framebuffer (H, W, 3), row 0 at
    the *bottom* (bottom-up DIB order, WinMain.cpp:217); ``radiance`` is the
    pre-tonemap float image for losses/grads; plus per-pixel aux buffers
    (the surviving fields of Camera::pixel_memory)."""

    image: jax.Array      # (H, W, 3) uint8
    radiance: jax.Array   # (H, W, 3) float32 (pre-tonemap, 0 on miss)
    hit_t: jax.Array      # (H, W) float32
    hit_tri: jax.Array    # (H, W) int32, -1 = miss
    hit_obj: jax.Array    # (H, W) int32, -1 = miss
    normal: jax.Array     # (H, W, 3) float32 world-space (0 on miss)
    point: jax.Array      # (H, W, 3) float32 world-space hit points


def trace_rays(scene: Scene, origin: jax.Array, rmd: jax.Array,
               config: RenderConfig, accel=None,
               band_h: int | None = None, band_w: int | None = None,
               proj=None) -> Hit:
    """Nearest hit over all objects. ``rmd``: (R, 3) world unit dirs from
    shared ``origin``; band_h*band_w == R (row-major) for the tiled path.
    ``proj``: camera Projection (world frame), required by method="bin".

    Pose-on-the-ray trick (Trixel.cu:60-66): geometry stays in its
    build-time frame; each object transforms the rays instead.
    """
    if config.with_stats:
        raise ValueError("with_stats makes intersect_binned return "
                         "(Hit, stats); call it directly for telemetry")
    best = Hit.miss(rmd.shape[0], config.draw_distance, rmd.dtype)
    for oi, obj in enumerate(scene.objects):
        d_obj = obj.pose.inv_apply_vec(rmd)
        o_obj = obj.pose.inv_apply(origin)
        if config.method == "brute":
            hit = mt_brute(o_obj, d_obj, obj.tris, config.draw_distance,
                           config.eps, config.chunk)
        elif config.method == "fixed":
            cache = FixedOriginCache.build(o_obj, obj.tris)
            hit = mt_fixed_origin(d_obj, cache, config.draw_distance,
                                  config.eps, config.chunk)
        elif config.method == "grid":
            from ..accel.traverse import intersect_clustered
            hit = intersect_clustered(o_obj, d_obj, obj.tris, accel[oi],
                                      config, band_h, band_w)
        elif config.method == "bin":
            from ..accel.traverse import intersect_binned
            if proj is None:
                raise ValueError('method="bin" needs the camera '
                                 "Projection (render() provides it)")
            hit = intersect_binned(o_obj, d_obj, obj.tris,
                                   proj.transformed(obj.pose), config,
                                   band_h, band_w)
        elif config.method == "raster":
            from ..accel.raster import intersect_raster
            if proj is None:
                raise ValueError('method="raster" needs the camera '
                                 "Projection (render() provides it)")
            hit = intersect_raster(o_obj, d_obj, obj.tris,
                                   proj.transformed(obj.pose), config,
                                   band_h, band_w)
        elif config.method == "kd":
            from ..accel.traverse import kd_intersect
            hit = kd_intersect(o_obj, d_obj, accel[oi],
                               config.draw_distance, config.eps)
        else:
            raise ValueError(f"unknown intersect method {config.method!r}")
        hit = hit.replace(
            obj=jnp.where(hit.tri >= 0, jnp.int32(oi), jnp.int32(-1)))
        best = best.merge(hit)
    return best


def shade_hits(scene: Scene, origin: jax.Array, rmd: jax.Array, hit: Hit,
               config: RenderConfig):
    """Differentiable shading given (stop-gradient) hit indices.

    Returns (radiance (R,3), normal (R,3), point (R,3), hit_mask (R,)).

    All per-ray math runs on flat (R,) component arrays: vectors are
    sliced into components once after the gather and only stacked back
    at the very end.
    """
    from ..ops.shade import phong_radiance_c

    num_r = rmd.shape[0]
    tri_idx = jnp.maximum(hit.tri, 0)
    # NINE flat (R,) accumulators, stacked to (R, 3) only at the return
    # boundary, so the residuals jax.grad saves stay flat arrays.
    acc = [jnp.zeros((num_r,), rmd.dtype) for _ in range(9)]

    dx, dy, dz = rmd[:, 0], rmd[:, 1], rmd[:, 2]             # world (R,)
    for oi, obj in enumerate(scene.objects):
        mask = (hit.obj == oi) & (hit.tri >= 0)
        # 12 columns: the unit normal is recomputed from the gathered
        # edges below instead of gathered, so vertex gradients flow
        # through the true normal dependence n(e1, e2). The table is
        # packed once from the flat component fields; gradients flow back
        # through the stack to each flat parameter leaf.
        t_ = obj.tris
        packed = jnp.concatenate(
            [jnp.stack([t_.p1x, t_.p1y, t_.p1z, t_.e1x, t_.e1y, t_.e1z,
                        t_.e2x, t_.e2y, t_.e2z], axis=1),
             t_.color], axis=1)                              # (T, 12)
        # one row gather; its transpose under jax.grad is XLA's
        # scatter-add into the (T, 12) table gradient
        rows = jnp.take(packed, tri_idx, axis=0)
        cr, cg, cb = rows[:, 9], rows[:, 10], rows[:, 11]

        # object-frame ray dir: R^T d, componentwise (R = pose rotation)
        m = obj.pose.matrix()                                 # (3, 3)
        ox_, oy_, oz_ = obj.pose.inv_apply(origin)
        ddx = m[0, 0] * dx + m[1, 0] * dy + m[2, 0] * dz
        ddy = m[0, 1] * dx + m[1, 1] * dy + m[2, 1] * dz
        ddz = m[0, 2] * dx + m[1, 2] * dy + m[2, 2] * dz

        # Möller–Trumbore t, componentized (same math as ops/intersect.py
        # mt_test: pvec = d x e2, det = e1.pvec, tvec = o - p1,
        # qvec = tvec x e1, t = e2.qvec/det), acceptance per Trixel.cu:
        # 106,127
        e1x, e1y, e1z = rows[:, 3], rows[:, 4], rows[:, 5]
        e2x, e2y, e2z = rows[:, 6], rows[:, 7], rows[:, 8]
        tvx = ox_ - rows[:, 0]
        tvy = oy_ - rows[:, 1]
        tvz = oz_ - rows[:, 2]
        pvx = ddy * e2z - ddz * e2y
        pvy = ddz * e2x - ddx * e2z
        pvz = ddx * e2y - ddy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        v = (ddx * qvx + ddy * qvy + ddz * qvz) * inv
        t_diff = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        eps = config.eps
        valid = ((jnp.abs(det) >= eps) & (u >= eps) & (v >= eps)
                 & (u + v <= 1.0 + eps) & (t_diff >= eps))
        # Differentiable t where the recompute agrees; fall back to the
        # traversal's t otherwise (degenerate/epsilon-edge cases).
        t = jnp.where(valid & mask, t_diff, hit.t)

        px = origin[0] + t * dx                              # world space
        py = origin[1] + t * dy
        pz = origin[2] + t * dz
        # object-frame unit normal from the gathered edges (same
        # convention as Triangles.from_vertices: n = normalize(e1 x e2),
        # the reference's init_tri_mem_cuda, Trixel.cu:11-27)
        cnx = e1y * e2z - e1z * e2y
        cny = e1z * e2x - e1x * e2z
        cnz = e1x * e2y - e1y * e2x
        # degenerate (zero-area) triangles get a zero normal; the guard
        # sits on rsqrt's INPUT so its derivative is never evaluated at 0
        # (an inf there times a zero cotangent is a NaN gradient — miss
        # rays gather triangle 0, which may be degenerate)
        nn = cnx * cnx + cny * cny + cnz * cnz
        inv_n = jnp.where(nn > 1e-30,
                          jax.lax.rsqrt(jnp.where(nn > 1e-30, nn, 1.0)),
                          0.0)
        nx_, ny_, nz_ = cnx * inv_n, cny * inv_n, cnz * inv_n
        nwx = m[0, 0] * nx_ + m[0, 1] * ny_ + m[0, 2] * nz_
        nwy = m[1, 0] * nx_ + m[1, 1] * ny_ + m[1, 2] * nz_
        nwz = m[2, 0] * nx_ + m[2, 1] * ny_ + m[2, 2] * nz_
        rr, rg, rb = phong_radiance_c((px, py, pz), (nwx, nwy, nwz),
                                      (dx, dy, dz), (cr, cg, cb),
                                      scene.phong)

        new = (rr, rg, rb, nwx, nwy, nwz, px, py, pz)
        acc = [jnp.where(mask, n, a) for n, a in zip(new, acc)]

    radiance = jnp.stack(acc[0:3], axis=-1)
    normal = jnp.stack(acc[3:6], axis=-1)
    point = jnp.stack(acc[6:9], axis=-1)
    return radiance, normal, point, hit.tri >= 0


def render_rays(scene: Scene, origin: jax.Array, rmd: jax.Array,
                config: RenderConfig, accel=None,
                band_h: int | None = None, band_w: int | None = None,
                proj=None):
    """Flat-ray pipeline (trace + shade + compose); the shard_map worker.

    Returns a dict of flat per-ray arrays.
    """
    from ..ops.shade import compose_framebuffer

    # Tangents are stopped at the traversal *inputs*, not just its output:
    # hit topology is non-differentiable by design (SURVEY.md §7 step 5),
    # and the Pallas intersection kernel defines no JVP rule — inputs with
    # tangents would make jax.grad's linearization fail on pallas_call.
    sg = jax.lax.stop_gradient
    hit = trace_rays(sg(scene), sg(origin), sg(rmd), config,
                     sg(accel), band_h, band_w,
                     None if proj is None else sg(proj))
    radiance, normal, point, hit_mask = shade_hits(
        scene, origin, rmd, hit, config)
    image = compose_framebuffer(radiance, hit_mask, config.background_rgb)
    return dict(
        image=image,
        radiance=jnp.where(hit_mask[..., None], radiance, 0.0),
        hit_t=hit.t, hit_tri=hit.tri, hit_obj=hit.obj,
        normal=normal, point=point,
    )


def render(scene: Scene, camera: Camera,
           config: RenderConfig = RenderConfig(), accel=None
           ) -> RenderOutput:
    """Full forward frame, single device. Jit with config static:

        frame = jax.jit(render, static_argnums=2)(scene, camera, config)
    """
    rmd = camera.ray_directions()                     # (R, 3)
    proj = (camera.projection() if config.method in ("bin", "raster")
            else None)
    flat = render_rays(scene, camera.pos, rmd, config, accel,
                       camera.res_h, camera.res_w, proj=proj)
    h, w = camera.res_h, camera.res_w

    def shape(x):
        return x.reshape(h, w, *x.shape[1:])

    return RenderOutput(**{k: shape(v) for k, v in flat.items()})


@partial(jax.jit, static_argnums=2)
def render_jit(scene: Scene, camera: Camera,
               config: RenderConfig = RenderConfig()) -> RenderOutput:
    return render(scene, camera, config)
