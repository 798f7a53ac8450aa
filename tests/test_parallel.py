"""Sharded rendering on the virtual 8-device CPU mesh (SURVEY.md §7 step 7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                        SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_tpu.parallel import mesh as pmesh
from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (make_train_step,
                                                             render_sharded)

CFG = RenderConfig(method="fixed", chunk=8)


@pytest.fixture(scope="module")
def scene(simple_tris):
    return Scene.create([SceneObject.create(
        Triangles.from_vertices(simple_tris))])


@pytest.fixture(scope="module")
def camera():
    return Camera.create(32, 32, pos=[0.0, 0.0, -1.0],
                         look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                         film_h=0.024, focal=0.01)


def test_eight_cpu_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single(scene, camera):
    m = pmesh.make_mesh(8)
    out_s = render_sharded(scene, camera, CFG, m)
    out_1 = render(scene, camera, CFG)
    np.testing.assert_array_equal(np.asarray(out_s.hit_tri),
                                  np.asarray(out_1.hit_tri))
    np.testing.assert_allclose(np.asarray(out_s.radiance),
                               np.asarray(out_1.radiance),
                               rtol=1e-5, atol=1e-6)


def test_sharded_render_2dev(scene, camera):
    m = pmesh.make_mesh(2)
    out_s = render_sharded(scene, camera, CFG, m)
    out_1 = render(scene, camera, CFG)
    np.testing.assert_array_equal(np.asarray(out_s.hit_tri),
                                  np.asarray(out_1.hit_tri))


def test_sharded_train_step_runs_and_matches_single(scene, camera):
    import optax
    m = pmesh.make_mesh(8)
    opt = optax.sgd(1e-3)
    params = {"scene": scene, "camera": camera}
    target = jnp.zeros((32, 32, 3))

    step_m = make_train_step(opt, CFG, m)
    step_1 = make_train_step(opt, CFG, None)

    st = opt.init(params)
    p_m, _, loss_m = step_m(params, st, target)
    p_1, _, loss_1 = step_1(params, st, target)
    np.testing.assert_allclose(float(loss_m), float(loss_1), rtol=1e-5)
    lm = jax.tree.leaves(p_m)
    l1 = jax.tree.leaves(p_1)
    for a, b in zip(lm, l1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_allreduce_nearest_hit():
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from cpp_cuda_raytracer_dev_tpu.ops.intersect import Hit
    from cpp_cuda_raytracer_dev_tpu.parallel.collectives import (
        allreduce_nearest_hit)

    m = pmesh.make_mesh(4, prims=4)
    # 4 shards each with a different candidate distance for 8 rays
    t = jnp.stack([jnp.full((8,), 10.0 + i) for i in range(4)])
    t = t.at[1, 3].set(0.5)          # shard 1 wins ray 3
    tri = jnp.tile(jnp.arange(8, dtype=jnp.int32)[None] + 100, (4, 1))
    tri = tri + jnp.arange(4, dtype=jnp.int32)[:, None] * 1000
    obj = jnp.zeros((4, 8), jnp.int32)
    miss = jnp.full((8,), 400.0)
    t = t.at[:, 7].set(400.0)        # everyone misses ray 7
    tri = tri.at[:, 7].set(-1)

    @partial(shard_map, mesh=m,
             in_specs=P(pmesh.PRIMS_AXIS, None),
             out_specs=P(pmesh.PRIMS_AXIS, None))
    def combine(t_, tri_, obj_):
        h = allreduce_nearest_hit(
            Hit(t=t_[0], tri=tri_[0], obj=obj_[0]), pmesh.PRIMS_AXIS)
        return (h.t[None], h.tri[None], h.obj[None])

    ct, ctri, cobj = combine(t, tri, obj)
    ct, ctri = np.asarray(ct), np.asarray(ctri)
    # all shards agree after combine
    assert (ct == ct[0]).all() and (ctri == ctri[0]).all()
    assert ct[0, 3] == 0.5 and ctri[0, 3] == 1103
    assert ct[0, 0] == 10.0 and ctri[0, 0] == 100
    assert ctri[0, 7] == -1 and ct[0, 7] == 400.0


def test_prims_sharded_render_matches_single(scene, camera):
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        render_sharded_2d)
    m = pmesh.make_mesh(8, prims=4)          # 2 ray bands x 4 prim shards
    out_s = render_sharded_2d(scene, camera, CFG, m)
    out_1 = render(scene, camera, CFG)
    np.testing.assert_array_equal(np.asarray(out_s.hit_tri),
                                  np.asarray(out_1.hit_tri))
    np.testing.assert_allclose(np.asarray(out_s.radiance),
                               np.asarray(out_1.radiance),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tester_setup(tester_path):
    """Fixture mesh + cluster accel for the accelerated-path sharding
    tests."""
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import ClusterAccel
    from cpp_cuda_raytracer_dev_tpu.io import ply

    mesh = ply.load_mesh(tester_path)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    sc = Scene.create([SceneObject.create(tris)])
    v = mesh.tri_vertices.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = Camera.create(
        64, 32, pos=center + np.array([0, 0, -1.3 * size]),
        look_at=center, up=[0, 1, 0], film_h=0.024, focal=0.055)
    accel = (ClusterAccel.build(tris, leaf_size=32),)
    cfg = RenderConfig(method="grid", leaf_size=32, tile_h=4, tile_w=32,
                       max_candidates=16, draw_distance=max(400.0, 10 * size))
    return sc, cam, accel, cfg


def test_grid_rays_sharded_matches_single(tester_setup):
    """The cluster path must run inside shard_map (rays axis) and agree
    with the single-device result."""
    sc, cam, accel, cfg = tester_setup
    m = pmesh.make_mesh(8)
    out_s = render_sharded(sc, cam, cfg, m, accel=accel)
    out_1 = render(sc, cam, cfg, accel=accel)
    agree = (np.asarray(out_s.hit_tri) == np.asarray(out_1.hit_tri)).mean()
    assert agree == 1.0, f"agreement {agree}"
    np.testing.assert_allclose(np.asarray(out_s.radiance),
                               np.asarray(out_1.radiance),
                               rtol=1e-5, atol=1e-6)


def test_grid_prim_sharded_matches_single(tester_setup):
    """Cluster-range sharding over "prims" + nearest-hit all-reduce must
    agree with the single-device cluster path."""
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        render_sharded_2d_accel)
    sc, cam, accel, cfg = tester_setup
    m = pmesh.make_mesh(8, prims=4)          # 2 ray bands x 4 prim shards
    out_s = render_sharded_2d_accel(sc, cam, cfg, m, accel)
    out_1 = render(sc, cam, cfg, accel=accel)
    agree = (np.asarray(out_s.hit_tri) == np.asarray(out_1.hit_tri)).mean()
    assert agree > 0.999, f"agreement {agree}"
    m_ok = np.asarray(out_s.hit_tri) == np.asarray(out_1.hit_tri)
    np.testing.assert_allclose(np.asarray(out_s.hit_t)[m_ok],
                               np.asarray(out_1.hit_t)[m_ok],
                               rtol=1e-4, atol=1e-5)


def test_grid_prim_sharded_grad_runs(tester_setup):
    """Gradients must flow through the prim-sharded accelerated path
    (psum of parameter grads over both mesh axes)."""
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        render_sharded_2d_accel)
    sc, cam, accel, cfg = tester_setup
    m = pmesh.make_mesh(4, prims=2)

    def loss(s):
        return jnp.mean(render_sharded_2d_accel(s, cam, cfg, m,
                                                accel).radiance)

    g = jax.grad(loss)(sc)
    leaves = [np.abs(np.asarray(x)).max() for x in jax.tree.leaves(g.phong)]
    assert np.isfinite(leaves).all() and max(leaves) > 0


def test_bin_method_rays_sharded_matches_single(tester_setup):
    """The binning path must run inside shard_map: each band re-bins with
    an adjust_y-shifted projection (affine pixel coords => band windows
    are a projection shift). Band rays are bit-identical to the full
    frame's and ties go to the smallest id, so every winner matches."""
    import dataclasses
    sc, cam, accel, cfg = tester_setup
    bcfg = dataclasses.replace(cfg, method="bin", tile_h=4, tile_w=32,
                               bin_chunk=64)
    m = pmesh.make_mesh(4)
    out_s = render_sharded(sc, cam, bcfg, m)
    out_1 = render(sc, cam, bcfg)
    np.testing.assert_array_equal(np.asarray(out_s.hit_tri),
                                  np.asarray(out_1.hit_tri))


def test_bin_prim_sharded_matches_single(tester_setup):
    """Main bin path on the 2-D rays x prims mesh: each prim shard bins
    only its contiguous triangle range, nearest hits min-combine over
    the prim axis."""
    import dataclasses

    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        render_sharded_2d_bin)
    sc, cam, accel, cfg = tester_setup
    bcfg = dataclasses.replace(cfg, method="bin", tile_h=4, tile_w=32,
                               bin_chunk=64)
    m = pmesh.make_mesh(8, prims=4)          # 2 ray bands x 4 prim shards
    out_s = render_sharded_2d_bin(sc, cam, bcfg, m)
    out_1 = render(sc, cam, bcfg)
    agree = (np.asarray(out_s.hit_tri) == np.asarray(out_1.hit_tri)).mean()
    assert agree > 0.999, f"agreement {agree}"
    m_ok = np.asarray(out_s.hit_tri) == np.asarray(out_1.hit_tri)
    np.testing.assert_allclose(np.asarray(out_s.hit_t)[m_ok],
                               np.asarray(out_1.hit_t)[m_ok],
                               rtol=1e-4, atol=1e-5)


def test_bin_prim_sharded_grad_runs(tester_setup):
    """Gradients must flow through the prim-sharded bin path."""
    import dataclasses

    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        render_sharded_2d_bin)
    sc, cam, accel, cfg = tester_setup
    bcfg = dataclasses.replace(cfg, method="bin", tile_h=4, tile_w=32,
                               bin_chunk=64)
    m = pmesh.make_mesh(4, prims=2)

    def loss(s):
        return jnp.mean(render_sharded_2d_bin(s, cam, bcfg, m).radiance)

    g = jax.grad(loss)(sc)
    leaves = [np.abs(np.asarray(x)).max() for x in jax.tree.leaves(g.phong)]
    assert np.isfinite(leaves).all() and max(leaves) > 0
