"""Sharded rendering and training over a device mesh.

Scaling design (SURVEY.md §5/§7, BASELINE.json north star): the image's row
axis is sharded over the "rays" mesh axis — forward rendering is then
embarrassingly parallel (zero cross-chip traffic: scene tables replicated,
each device culls + intersects + shades its own row band). The backward
pass all-reduces parameter gradients; with `shard_map` + `jax.grad`, XLA
inserts and overlaps those psums automatically.

Optionally the triangle axis is also sharded ("prims"): each device holds a
contiguous primitive range and the per-ray nearest hit is min-combined with
`allreduce_nearest_hit`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models.camera import Camera
from ..models.renderer import RenderOutput, render_rays
from ..models.scene import Scene
from ..utils.config import RenderConfig
from .mesh import RAYS_AXIS


def _check_band(camera: Camera, mesh: Mesh, config: RenderConfig) -> int:
    n = mesh.shape[RAYS_AXIS]
    if camera.res_h % n:
        raise ValueError(
            f"res_h={camera.res_h} must divide over {n} devices")
    return camera.res_h // n


def render_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                   mesh: Mesh, accel=None) -> RenderOutput:
    """Forward frame with image rows sharded over mesh axis "rays".

    Scene/camera replicate, per-pixel outputs come back row-sharded
    (harvest or all-gather as needed). Every sharded entry point here
    jits its shard_map body: executed op by op, a shard_map over several
    devices costs tens of seconds even for a tiny frame.
    """
    band_h = _check_band(camera, mesh, config)
    rmd = camera.ray_directions().reshape(camera.res_h, camera.res_w, 3)
    proj = (camera.projection() if config.method in ("bin", "raster")
            else None)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(RAYS_AXIS, None, None)),
             out_specs=P(RAYS_AXIS),
             check_vma=False)
    def worker(scene_, origin, band):
        proj_band = None
        if proj is not None:
            # the band's pixel rows start at row0 = index*band_h; the
            # projection's iy offset shifts accordingly (pixel coords are
            # affine, so band windows are just an adjust_y shift)
            row0 = jax.lax.axis_index(RAYS_AXIS) * band_h
            proj_band = proj.replace(
                adjust_y=proj.adjust_y - row0.astype(proj.adjust_y.dtype))
        flat = render_rays(scene_, origin, band.reshape(-1, 3), config,
                           accel, band_h, camera.res_w, proj=proj_band)
        return jax.tree.map(
            lambda x: x.reshape(band_h, camera.res_w, *x.shape[1:]), flat)

    out = jax.jit(worker)(scene, camera.pos, rmd)
    return RenderOutput(**out)


def render_sharded_2d(scene: Scene, camera: Camera, config: RenderConfig,
                      mesh: Mesh) -> RenderOutput:
    """Forward frame on a 2-D ("rays", "prims") mesh: image rows sharded
    over "rays" AND each object's triangle range sharded over "prims".

    Every prim shard intersects only its own contiguous triangle range
    (the matmul-form fixed-origin path), the per-ray nearest hit is
    min-combined across the prim axis (`allreduce_nearest_hit` — two
    collectives), and shading runs on the combined hit. This is the
    multi-device generalization of the reference's per-thread nearest-hit
    select (Trixel.cu:127-142); see SURVEY.md §5 "long-context analogue".
    """
    from ..models.renderer import shade_hits
    from ..models.scene import Triangles
    from ..ops.intersect import FixedOriginCache, Hit, mt_fixed_origin
    from ..ops.shade import compose_framebuffer
    from .collectives import allreduce_nearest_hit
    from .mesh import PRIMS_AXIS

    band_h = _check_band(camera, mesh, config)
    nprims = mesh.shape[PRIMS_AXIS]
    res_w = camera.res_w
    rmd = camera.ray_directions().reshape(camera.res_h, res_w, 3)

    def shard_tris(tris: Triangles, pi):
        """Contiguous range [pi*chunk, (pi+1)*chunk) of (padded) slots."""
        t = tris.num_triangles
        chunk = -(-t // nprims)
        pad = chunk * nprims - t

        def cut(x):
            fill = jnp.zeros((pad,) + x.shape[1:], x.dtype)
            return jax.lax.dynamic_slice_in_dim(
                jnp.concatenate([x, fill]), pi * chunk, chunk)

        return jax.tree.map(cut, tris), chunk

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(RAYS_AXIS, None, None)),
             out_specs=P(RAYS_AXIS),
             check_vma=False)
    def worker(scene_, origin, band):
        pi = jax.lax.axis_index(PRIMS_AXIS)
        d_flat = band.reshape(-1, 3)
        best = Hit.miss(d_flat.shape[0], config.draw_distance)
        for oi, obj in enumerate(scene_.objects):
            d_obj = obj.pose.inv_apply_vec(d_flat)
            o_obj = obj.pose.inv_apply(origin)
            sub, chunk = shard_tris(obj.tris, pi)
            cache = FixedOriginCache.build(o_obj, sub)
            hit = mt_fixed_origin(d_obj, cache, config.draw_distance,
                                  config.eps, config.chunk)
            hit = hit.replace(
                tri=jnp.where(hit.tri >= 0, hit.tri + pi * chunk, -1),
                obj=jnp.where(hit.tri >= 0, jnp.int32(oi), jnp.int32(-1)))
            best = best.merge(hit)
        best = allreduce_nearest_hit(best, PRIMS_AXIS)
        best = jax.lax.stop_gradient(best)
        radiance, normal, point, hit_mask = shade_hits(
            scene_, origin, d_flat, best, config)
        image = compose_framebuffer(radiance, hit_mask,
                                    config.background_rgb)
        flat = dict(
            image=image,
            radiance=jnp.where(hit_mask[..., None], radiance, 0.0),
            hit_t=best.t, hit_tri=best.tri, hit_obj=best.obj,
            normal=normal, point=point,
        )
        return jax.tree.map(
            lambda x: x.reshape(band_h, res_w, *x.shape[1:]), flat)

    out = jax.jit(worker)(scene, camera.pos, rmd)
    return RenderOutput(**out)


def shard_accel(accel, nprims: int):
    """Split a ClusterAccel into `nprims` contiguous cluster ranges,
    stacked on a new leading axis (so shard_map's in_specs can shard it
    over the "prims" mesh axis). Clusters are in KD-leaf order, so each
    range is spatially coherent. Padding clusters are inverted-empty boxes
    (every frustum plane test fails => never a candidate) with zero
    geometry (det == 0 => never a hit) and slot -1."""
    from ..accel.traverse import ClusterAccel

    c = accel.num_clusters
    cp = -(-c // nprims)
    pad = cp * nprims - c
    big = jnp.float32(3.0e38)

    def cut(x, fill):
        if pad:
            f = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
            x = jnp.concatenate([x, f])
        return x.reshape(nprims, cp, *x.shape[1:])

    return ClusterAccel(
        bounds_min=cut(accel.bounds_min, big),
        bounds_max=cut(accel.bounds_max, -big),
        centers=cut(accel.centers, 0.0),
        geom_t=cut(accel.geom_t, 0.0),
        slot_mat=cut(accel.slot_mat, -1),
        leaf_size=accel.leaf_size,
    )


def render_sharded_2d_accel(scene: Scene, camera: Camera,
                            config: RenderConfig, mesh: Mesh,
                            accel) -> RenderOutput:
    """Cluster-accelerated (method="grid") rendering on a 2-D
    ("rays", "prims") mesh: image rows sharded over "rays", each object's
    *cluster ranges* sharded over "prims" (`shard_accel`). Every prim
    shard culls + intersects only its own clusters; the per-ray nearest
    hit is min-combined across the prim axis (`allreduce_nearest_hit`)
    and shading runs on the combined hit. This is the accelerated-path
    generalization of `render_sharded_2d` (which shards raw triangle
    ranges of the brute path)."""
    from ..models.renderer import shade_hits, trace_rays
    from ..ops.shade import compose_framebuffer
    from .collectives import allreduce_nearest_hit
    from .mesh import PRIMS_AXIS

    band_h = _check_band(camera, mesh, config)
    nprims = mesh.shape[PRIMS_AXIS]
    res_w = camera.res_w
    rmd = camera.ray_directions().reshape(camera.res_h, res_w, 3)
    stacked = tuple(shard_accel(a, nprims) for a in accel)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(RAYS_AXIS, None, None), P(PRIMS_AXIS)),
             out_specs=P(RAYS_AXIS),
             check_vma=False)
    def worker(scene_, origin, band, accel_s):
        accel_local = jax.tree.map(lambda x: x[0], accel_s)
        d_flat = band.reshape(-1, 3)
        # tangents stop at the traversal *inputs* (see models/renderer.py
        # render_rays); hit topology is non-differentiable by design,
        # shading re-derives t.
        sg = jax.lax.stop_gradient
        hit = trace_rays(sg(scene_), sg(origin), sg(d_flat), config,
                         sg(accel_local), band_h, res_w)
        hit = allreduce_nearest_hit(hit, PRIMS_AXIS)
        radiance, normal, point, hit_mask = shade_hits(
            scene_, origin, d_flat, hit, config)
        image = compose_framebuffer(radiance, hit_mask,
                                    config.background_rgb)
        flat = dict(
            image=image,
            radiance=jnp.where(hit_mask[..., None], radiance, 0.0),
            hit_t=hit.t, hit_tri=hit.tri, hit_obj=hit.obj,
            normal=normal, point=point,
        )
        return jax.tree.map(
            lambda x: x.reshape(band_h, res_w, *x.shape[1:]), flat)

    out = jax.jit(worker)(scene, camera.pos, rmd, stacked)
    return RenderOutput(**out)


def render_sharded_2d_bin(scene: Scene, camera: Camera,
                          config: RenderConfig, mesh: Mesh) -> RenderOutput:
    """Main-path (method="bin") rendering on a 2-D ("rays", "prims") mesh: image
    rows sharded over "rays" AND each object's triangle range sharded
    over "prims". Every prim shard bins + intersects only its own
    contiguous triangle range against its row band (the screen-space cull
    is per-shard exact — binning a subset is still conservative for that
    subset), then the per-ray nearest hit is min-combined across the prim
    axis (`allreduce_nearest_hit`, two collectives) and shading runs
    on the combined hit. Winner triangle ids are shifted by the shard's
    slot offset so shading gathers from the full replicated tables.
    """
    from ..models.renderer import shade_hits
    from ..ops.intersect import Hit
    from ..ops.shade import compose_framebuffer
    from .collectives import allreduce_nearest_hit
    from .mesh import PRIMS_AXIS

    if config.with_stats:
        raise ValueError("with_stats makes intersect_binned return "
                         "(Hit, stats); call it directly for telemetry "
                         "(models/renderer.py trace_rays has the same "
                         "contract)")
    band_h = _check_band(camera, mesh, config)
    nprims = mesh.shape[PRIMS_AXIS]
    res_w = camera.res_w
    rmd = camera.ray_directions().reshape(camera.res_h, res_w, 3)
    proj = camera.projection()

    def shard_tris(tris, pi):
        t = tris.num_triangles
        chunk = -(-t // nprims)
        pad = chunk * nprims - t

        def cut(x):
            fill = jnp.zeros((pad,) + x.shape[1:], x.dtype)
            return jax.lax.dynamic_slice_in_dim(
                jnp.concatenate([x, fill]), pi * chunk, chunk)

        return jax.tree.map(cut, tris), chunk

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(RAYS_AXIS, None, None)),
             out_specs=P(RAYS_AXIS),
             check_vma=False)
    def worker(scene_, origin, band):
        from ..accel.traverse import intersect_binned

        pi = jax.lax.axis_index(PRIMS_AXIS)
        row0 = jax.lax.axis_index(RAYS_AXIS) * band_h
        d_flat = band.reshape(-1, 3)
        sg = jax.lax.stop_gradient
        best = Hit.miss(d_flat.shape[0], config.draw_distance)
        for oi, obj in enumerate(scene_.objects):
            o_obj = obj.pose.inv_apply(origin)
            proj_obj = proj.transformed(obj.pose).replace(
                adjust_y=proj.adjust_y - row0.astype(proj.adjust_y.dtype))
            sub, chunk = shard_tris(obj.tris, pi)
            # padding slots are zero triangles: det == 0 rejects them
            hit = intersect_binned(sg(o_obj), sg(d_flat), sg(sub),
                                   sg(proj_obj), config, band_h, res_w)
            hit = hit.replace(
                tri=jnp.where(hit.tri >= 0, hit.tri + pi * chunk, -1),
                obj=jnp.where(hit.tri >= 0, jnp.int32(oi), jnp.int32(-1)))
            best = best.merge(hit)
        best = allreduce_nearest_hit(best, PRIMS_AXIS)
        best = jax.lax.stop_gradient(best)
        radiance, normal, point, hit_mask = shade_hits(
            scene_, origin, d_flat, best, config)
        image = compose_framebuffer(radiance, hit_mask,
                                    config.background_rgb)
        flat = dict(
            image=image,
            radiance=jnp.where(hit_mask[..., None], radiance, 0.0),
            hit_t=best.t, hit_tri=best.tri, hit_obj=best.obj,
            normal=normal, point=point,
        )
        return jax.tree.map(
            lambda x: x.reshape(band_h, res_w, *x.shape[1:]), flat)

    out = jax.jit(worker)(scene, camera.pos, rmd)
    return RenderOutput(**out)


def radiance_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                     mesh: Mesh, accel=None) -> jax.Array:
    """Differentiable sharded radiance image (H, W, 3) — the loss input."""
    return render_sharded(scene, camera, config, mesh, accel).radiance


def make_loss_fn(config: RenderConfig, mesh: Mesh | None, accel=None):
    """L2 image loss vs a target, differentiable w.r.t. (scene, camera).

    With mesh=None runs single-device (uses models.renderer.render).
    """
    def loss_fn(params, target):
        scene, camera = params["scene"], params["camera"]
        if mesh is None:
            from ..models.renderer import render
            rad = render(scene, camera, config, accel).radiance
        else:
            rad = radiance_sharded(scene, camera, config, mesh, accel)
        return jnp.mean((rad - target) ** 2)
    return loss_fn


def make_train_step(optimizer, config: RenderConfig, mesh: Mesh | None,
                    accel=None):
    """SGD step over scene/camera parameters: grads of the sharded loss are
    all-reduced by XLA (psum overlapped with backward)."""
    loss_fn = make_loss_fn(config, mesh, accel)

    def step(params, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
