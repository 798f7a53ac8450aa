import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu.accel.kd_build import build_kd, validate_kd
from cpp_cuda_raytracer_dev_tpu.accel.traverse import (ClusterAccel, KDTables,
                                                       kd_intersect)
from cpp_cuda_raytracer_dev_tpu.io import ply
from cpp_cuda_raytracer_dev_tpu.models.scene import Triangles
from cpp_cuda_raytracer_dev_tpu.ops.intersect import mt_brute


@pytest.fixture(scope="module")
def tester_mesh(tester_path):
    return ply.load_mesh(tester_path)


def test_kd_invariants_leaf1(tester_mesh):
    tree = build_kd(tester_mesh.aabb_min, tester_mesh.aabb_max,
                    min_node_size=1)
    # 2n-1 complete tree like the reference (Trixel.h:115)
    n = tester_mesh.num_triangles
    assert tree.num_nodes == 2 * n - 1
    assert tree.num_leaves == n
    assert (tree.leaf_count[tree.is_leaf] == 1).all()
    validate_kd(tree, tester_mesh.aabb_min, tester_mesh.aabb_max)
    # median split: depth ~ log2(n)
    assert tree.max_depth <= int(np.ceil(np.log2(n))) + 1


def test_kd_invariants_wide_leaves(tester_mesh):
    tree = build_kd(tester_mesh.aabb_min, tester_mesh.aabb_max,
                    min_node_size=32)
    validate_kd(tree, tester_mesh.aabb_min, tester_mesh.aabb_max)
    assert tree.leaf_count[tree.is_leaf].max() <= 32


def rays_at(mesh, n_side=24):
    lo = mesh.tri_vertices.reshape(-1, 3).min(0)
    hi = mesh.tri_vertices.reshape(-1, 3).max(0)
    center = (lo + hi) / 2
    o = jnp.asarray(center + np.array([0, 0, -(hi - lo)[2] * 2 - 1],
                                      np.float32))
    # a grid over the central 90% of the mesh's x/y extent
    gx, gy = np.meshgrid(np.linspace(-0.45, 0.45, n_side),
                         np.linspace(-0.45, 0.45, n_side))
    tgt = center + np.stack([gx.ravel() * (hi - lo)[0],
                             gy.ravel() * (hi - lo)[1],
                             np.zeros(n_side * n_side)], -1)
    d = tgt - np.asarray(o)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


def test_kd_traversal_matches_brute(tester_mesh):
    tris = Triangles.from_vertices(tester_mesh.tri_vertices)
    o, d = rays_at(tester_mesh)
    brute = mt_brute(o, d, tris, draw_distance=1e4, chunk=256)

    tree = build_kd(tester_mesh.aabb_min, tester_mesh.aabb_max,
                    min_node_size=4)
    tables = KDTables.from_tree(tree, tris)
    kd = kd_intersect(o, d, tables, draw_distance=1e4)

    hit_rate = float(np.mean(np.asarray(brute.tri) >= 0))
    assert hit_rate > 0.5, "fixture should mostly hit the mesh"
    np.testing.assert_allclose(kd.t, brute.t, rtol=1e-4, atol=1e-5)
    agree = np.mean(np.asarray(kd.tri) == np.asarray(brute.tri))
    assert agree > 0.99


def test_cluster_accel_structure(tester_mesh):
    tris = Triangles.from_vertices(tester_mesh.tri_vertices)
    accel = ClusterAccel.build(tris, leaf_size=32)
    n = tester_mesh.num_triangles
    # every triangle appears in exactly one slot
    st = np.asarray(accel.slot_tri)
    real = st[st >= 0]
    assert real.shape[0] == n
    assert np.unique(real).shape[0] == n
    # slot geometry matches the original triangles
    ids = st.reshape(-1)
    mask = ids >= 0
    np.testing.assert_allclose(np.asarray(accel.p1)[mask],
                               np.asarray(tris.p1)[ids[mask]])


def test_kd_disk_cache_roundtrip(tmp_path):
    import numpy as np
    from cpp_cuda_raytracer_dev_tpu.accel.kd_build import build_kd
    from cpp_cuda_raytracer_dev_tpu.utils import cache

    rng = np.random.default_rng(7)
    lo = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.2, (64, 3)).astype(np.float32)
    t1 = cache.build_kd_cached(lo, hi, min_node_size=4,
                               cache_dir=str(tmp_path))
    t2 = cache.build_kd_cached(lo, hi, min_node_size=4,
                               cache_dir=str(tmp_path))  # cache hit
    ref = build_kd(lo, hi, min_node_size=4)
    for f in ("bounds_min", "bounds_max", "cut_code", "s1", "s2", "left",
              "right", "parent", "leaf_start", "leaf_count", "perm"):
        np.testing.assert_array_equal(getattr(t2, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(t1, f), getattr(ref, f))
    # a different build parameter keys a different entry
    t3 = cache.build_kd_cached(lo, hi, min_node_size=8,
                               cache_dir=str(tmp_path))
    assert t3.num_leaves != t2.num_leaves or t3.min_node_size == 8


def test_kd_ray_chunking_equivalent(tester_mesh):
    """The ray-slab chunking (bounds live per-ray state for large
    validation runs) must be exactly the unchunked traversal."""
    tris = Triangles.from_vertices(tester_mesh.tri_vertices)
    o, d = rays_at(tester_mesh)
    tree = build_kd(tester_mesh.aabb_min, tester_mesh.aabb_max,
                    min_node_size=4)
    tables = KDTables.from_tree(tree, tris)
    full = kd_intersect(o, d, tables, draw_distance=1e4, ray_chunk=0)
    # chunk smaller than the batch and NOT dividing it (exercises padding)
    slab = kd_intersect(o, d, tables, draw_distance=1e4, ray_chunk=48)
    np.testing.assert_array_equal(np.asarray(full.tri),
                                  np.asarray(slab.tri))
    np.testing.assert_array_equal(np.asarray(full.t), np.asarray(slab.t))
