"""Screen-space binning cull (accel/binning.py) + bin kernel
(ops/pallas/bin_intersect.py, interpret mode on CPU).

The critical property is *conservativeness*: a pixel's ray can only hit a
triangle whose projection covers that pixel, so the triangle must be in
the pixel's tile bin — binning may over-include (harmless: extra MT
tests) but must never drop a hittable pair. The reference's KD traversal
is exact (Trixel.cu:70-169); so must the cull be.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                        SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles
from cpp_cuda_raytracer_dev_tpu.io import ply
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose, from_axis_angle

RES_W, RES_H, TH, TW = 128, 64, 16, 16


@pytest.fixture(scope="module")
def tester(tester_path):
    mesh = ply.load_mesh(tester_path)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    v = mesh.tri_vertices.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    return tris, center, size


def _camera(center, size, off):
    return Camera.create(RES_W, RES_H, pos=center + np.asarray(off),
                         look_at=center, up=[0, 1, 0], film_h=0.024,
                         focal=0.055)


@pytest.mark.parametrize("off_scale", [
    (0.0, 0.0, -1.3), (0.5, 0.1, 0.5), (0.0, 0.0, 0.3), (-0.7, 0.4, -0.4)])
def test_binning_conservative(tester, off_scale):
    """Every oracle hit's triangle must be in the pixel's tile bin."""
    tris, center, size = tester
    scene = Scene.create([SceneObject.create(tris)])
    cam = _camera(center, size, np.asarray(off_scale) * size)
    dd = max(400.0, 10 * size)
    hit_tri = np.asarray(render(scene, cam, RenderConfig(
        method="fixed", chunk=512, draw_distance=dd)).hit_tri)

    binned = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                           tris.p1, tris.e1, tris.e2,
                           RES_H, RES_W, TH, TW,
                           e_cap=tris.num_triangles * 8 + 4096)
    assert int(binned.overflow_entries) == 0
    starts = np.asarray(binned.starts)
    et = np.asarray(binned.entry_tri)
    n_tx = -(-RES_W // TW)

    ys, xs = np.nonzero(hit_tri >= 0)
    assert len(ys) > 100
    misses = 0
    for iy, ix in zip(ys, xs):
        tile = (iy // TH) * n_tx + (ix // TW)
        if hit_tri[iy, ix] not in et[starts[tile]:starts[tile + 1]]:
            misses += 1
    assert misses == 0, f"{misses}/{len(ys)} hit pairs dropped by binning"


def test_binning_depth_sorted_within_tile(tester):
    """The depth row must be non-decreasing within each tile (the kernel
    stops at the first entry whose certificate passes its rays) and must
    bound each entry's own min-vertex depth from below."""
    tris, center, size = tester
    cam = _camera(center, size, [0, 0, -1.3 * size])
    binned = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                           tris.p1, tris.e1, tris.e2,
                           RES_H, RES_W, TH, TW,
                           e_cap=tris.num_triangles * 8 + 4096)
    starts = np.asarray(binned.starts)
    depth = np.asarray(binned.geom)[10].reshape(-1)
    et = np.asarray(binned.entry_tri)
    vert = np.asarray(tris.vertices()) - np.asarray(cam.pos)
    n = np.asarray(cam.projection().n)
    own = (vert @ n).min(axis=1)                     # per-triangle depth
    for t in range(len(starts) - 1):
        seg = depth[starts[t]:starts[t + 1]]
        if len(seg) > 1:
            assert (np.diff(seg) >= 0).all()
        ids = et[starts[t]:starts[t + 1]]
        assert (seg <= np.maximum(own[ids], 0) + 1e-5).all()


@pytest.mark.parametrize("off_scale", [(0.0, 0.0, -1.3), (0.5, 0.1, 0.5)])
def test_bin_render_matches_oracle(tester, off_scale):
    tris, center, size = tester
    scene = Scene.create([SceneObject.create(tris)])
    cam = _camera(center, size, np.asarray(off_scale) * size)
    dd = max(400.0, 10 * size)
    ref = render(scene, cam, RenderConfig(method="fixed", chunk=512,
                                          draw_distance=dd))
    out = render(scene, cam, RenderConfig(method="bin", tile_h=TH,
                                          tile_w=TW, bin_chunk=64,
                                          draw_distance=dd))
    rt, bt = np.asarray(ref.hit_tri), np.asarray(out.hit_tri)
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree}"
    m = (rt >= 0) & (rt == bt)
    np.testing.assert_allclose(np.asarray(out.hit_t)[m],
                               np.asarray(ref.hit_t)[m],
                               rtol=3e-4, atol=1e-4)


def test_bin_render_posed_object(tester):
    """Projection must follow the object pose (pose-on-the-cull)."""
    tris, center, size = tester
    pose = Pose(quat=from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.7),
                translation=jnp.array([0.2, -0.1, 0.3]) * size)
    scene = Scene.create([SceneObject.create(tris, pose)])
    cam = _camera(center, size, [0, 0, -1.5 * size])
    dd = max(400.0, 10 * size)
    ref = render(scene, cam, RenderConfig(method="fixed", chunk=512,
                                          draw_distance=dd))
    out = render(scene, cam, RenderConfig(method="bin", tile_h=TH,
                                          tile_w=TW, bin_chunk=64,
                                          draw_distance=dd))
    rt, bt = np.asarray(ref.hit_tri), np.asarray(out.hit_tri)
    assert (rt >= 0).mean() > 0.1
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree}"


def test_bin_camera_inside_scene(tester):
    """Camera inside the mesh: many triangles cross the camera plane and
    bin conservatively to EVERY tile (accel/binning.py cross handling) —
    the degenerate full-broadcast regime must stay exact, just slow
    """
    tris, center, size = tester
    scene = Scene.create([SceneObject.create(tris)])
    # inside the closed tester mesh, looking sideways
    cam = _camera(center, size, np.asarray([0.05, 0.02, 0.04]) * size)
    dd = max(400.0, 10 * size)
    ref = render(scene, cam, RenderConfig(method="fixed", chunk=512,
                                          draw_distance=dd))
    out = render(scene, cam, RenderConfig(
        method="bin", tile_h=TH, tile_w=TW, bin_chunk=64,
        bin_e_factor=40.0,     # cross tris replicate to all 32 tiles
        draw_distance=dd))
    rt, bt = np.asarray(ref.hit_tri), np.asarray(out.hit_tri)
    assert (rt >= 0).mean() > 0.5, "camera should see geometry all around"
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree}"


def test_bin_overflow_reported(tester):
    """An undersized entry table must be REPORTED (overflow_entries > 0),
    never silent — the render path drops geometry when e_cap is exceeded.
    The render path surfaces the same scalar through
    intersect_binned(with_stats)."""
    tris, center, size = tester
    cam = _camera(center, size, [0, 0, -1.3 * size])
    binned = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                           tris.p1, tris.e1, tris.e2,
                           RES_H, RES_W, TH, TW, e_cap=256, chunk=64)
    assert int(binned.overflow_entries) > 0
    assert int(binned.num_entries) == 256  # clamped at the cap


@pytest.mark.parametrize("e_cap,chunk", [(512, 64), (1024, 64), (448, 64)])
def test_starts_exact_vs_numpy(tester, e_cap, chunk):
    """Per-tile segment starts must equal numpy's lower_bound over the
    sorted keys — including power-of-two e_cap, where an understated
    starts[t] would truncate tile t-1's segment."""
    tris, center, size = tester
    cam = _camera(center, size, [0, 0, -1.3 * size])
    n_tiles = (-(-RES_W // TW)) * (-(-RES_H // TH))
    dbits = 31 - n_tiles.bit_length()
    key, _ = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                           tris.p1, tris.e1, tris.e2,
                           RES_H, RES_W, TH, TW,
                           e_cap=e_cap, chunk=chunk, _stage="sort")
    starts, _ = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                              tris.p1, tris.e1, tris.e2,
                              RES_H, RES_W, TH, TW,
                              e_cap=e_cap, chunk=chunk, _stage="starts")
    key = np.asarray(key).astype(np.int64)
    n_valid = int((key != 2**31 - 1).sum())
    expect = np.minimum(
        np.searchsorted(key, np.arange(n_tiles, dtype=np.int64) << dbits,
                        side="left"),
        n_valid)
    got = np.asarray(starts)
    np.testing.assert_array_equal(got[:-1], expect)
    assert got[-1] == n_valid


def test_cross_tri_zero_depth_certificate():
    """Camera-plane-crossing triangles must carry a 0 depth certificate:
    their hit can be NEARER than the min front-vertex depth, so a
    positive certificate could let the kernel stop before the entry
    holding the true nearest hit."""
    cam = Camera.create(RES_W, RES_H, pos=[0.0, 0.0, 0.0],
                        look_at=[0.0, 0.0, 1.0], up=[0, 1, 0],
                        film_h=0.024, focal=0.055)
    # one vertex behind the camera plane, two far in front: the visible
    # sliver near the camera is much closer than either front vertex
    tv = np.array([[[0.0, -0.5, -1.0],
                    [0.5, 0.5, 8.0],
                    [-0.5, 0.5, 8.0]]], np.float32)
    tris = Triangles.from_vertices(tv)
    binned = bin_triangles(cam.projection(), jnp.asarray(cam.pos),
                           tris.p1, tris.e1, tris.e2,
                           RES_H, RES_W, TH, TW, e_cap=64, chunk=64)
    assert int(binned.cross_tris) == 1
    depth_row = np.asarray(binned.geom)[10].reshape(-1)
    live = np.asarray(binned.entry_tri) >= 0
    assert live.sum() == 32          # full-screen: every tile
    np.testing.assert_array_equal(depth_row[live], 0.0)


def test_bin_grad_flows(tester):
    tris, center, size = tester
    scene = Scene.create([SceneObject.create(tris)])
    cam = _camera(center, size, [0, 0, -1.3 * size])
    dd = max(400.0, 10 * size)
    cfg = RenderConfig(method="bin", tile_h=TH, tile_w=TW, bin_chunk=64,
                       draw_distance=dd)

    def loss(s):
        return jnp.mean(render(s, cam, cfg).radiance)

    g = jax.grad(loss)(scene)
    leaves = [np.abs(np.asarray(x)).max() for x in jax.tree.leaves(g.phong)]
    assert np.isfinite(leaves).all() and max(leaves) > 0


def test_backface_cull_exact_on_closed_mesh():
    """backface_cull drops ~half the entries on a closed watertight
    surface viewed from outside while the nearest hit stays the oracle's
    (a back-side hit is always occluded by a nearer front face). The
    only tolerated flips are exact-t ties at silhouette shared edges."""
    from cpp_cuda_raytracer_dev_tpu.models.renderer import trace_rays
    from cpp_cuda_raytracer_dev_tpu.utils.procgen import uv_sphere

    tris = Triangles.from_vertices(uv_sphere(50, 50, roughness=0.03))
    scene = Scene.create([SceneObject.create(tris)])
    cam = Camera.create(96, 64, pos=[0.0, 0.2, -3.0],
                        look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                        film_h=0.024, focal=0.055)
    rmd = cam.ray_directions()
    proj = cam.projection()
    kw = dict(method="bin", bin_chunk=128)
    hit_n = trace_rays(scene, cam.pos, rmd, RenderConfig(**kw), None,
                       cam.res_h, cam.res_w, proj=proj)
    hit_c = trace_rays(scene, cam.pos, rmd,
                       RenderConfig(backface_cull=True, **kw), None,
                       cam.res_h, cam.res_w, proj=proj)
    tri_n, tri_c = np.asarray(hit_n.tri), np.asarray(hit_c.tri)
    mism = np.nonzero(tri_n != tri_c)[0]
    # any flip must be an exact-t tie, never a dropped/worse hit
    t_n, t_c = np.asarray(hit_n.t), np.asarray(hit_c.t)
    assert mism.size <= 0.001 * tri_n.size
    np.testing.assert_allclose(t_c[mism], t_n[mism], rtol=1e-4)
    # and the cull must actually drop entries (the point of the flag)
    from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles
    e = []
    for cull in (False, True):
        b = bin_triangles(proj, jnp.asarray(cam.pos), tris.p1, tris.e1,
                          tris.e2, 64, 96, 16, 32, e_cap=131072,
                          chunk=128, backface_cull=cull)
        e.append(int(b.num_entries))
    assert e[1] < 0.7 * e[0]


def test_bin_grads_all_finite():
    """fwd+bwd over every scene leaf and the camera stays finite on a mesh
    with degenerate (zero-area) pole triangles, which miss rays gather."""
    from cpp_cuda_raytracer_dev_tpu.utils.procgen import dragon_class_mesh

    tris = Triangles.from_vertices(dragon_class_mesh(2000, seed=1))
    scene = Scene.create([SceneObject.create(tris)])
    cam = Camera.create(64, 32, pos=[0.0, 0.0, -3.0], look_at=[0, 0, 0],
                        up=[0, 1, 0], film_h=0.024, focal=0.055)
    cfg = RenderConfig(method="bin", bin_chunk=32)
    w = jnp.linspace(0.3, 1.7, 64 * 32 * 3).reshape(32, 64, 3)

    def loss(s, c):
        return jnp.mean(render(s, c, cfg).radiance * w)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(scene, cam)
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert max(float(np.abs(np.asarray(x)).max()) for x in leaves) > 0
