import numpy as np

from cpp_cuda_raytracer_dev_tpu.io import ply
from cpp_cuda_raytracer_dev_tpu.utils import procgen
from meshes import (TESTER_ARGS, TESTER_LAT, TESTER_LON,
                    fixture_tester_grid, indexed, rabbit_indexed, walls_mesh)


def test_rabbit_ascii(rabbit_path):
    """ASCII PLY with bare `element` lines (no `property` declarations)
    and five vertex columns: the width is inferred from the body."""
    v, faces = rabbit_indexed()
    mesh = ply.load_mesh(rabbit_path)
    assert mesh.vertices.shape == v.shape
    np.testing.assert_array_equal(mesh.vertices, v)
    assert mesh.num_triangles == len(faces)
    # reference rewind (read_ply.cpp:138-148): stored tri = (p3, p1, p2)
    p1, p2, p3 = faces[0]
    np.testing.assert_allclose(mesh.tri_vertices[0],
                               mesh.vertices[[p3, p1, p2]])
    # AABBs bound their triangles
    assert (mesh.aabb_min <= mesh.tri_vertices.min(axis=1) + 1e-6).all()
    assert (mesh.aabb_max >= mesh.tri_vertices.max(axis=1) - 1e-6).all()


def test_walls_binary(walls_path):
    """Binary little-endian PLY with normals and mixed tris/quads."""
    v, _, faces = walls_mesh()
    mesh = ply.load_mesh(walls_path)
    np.testing.assert_array_equal(mesh.vertices, v)
    # two triangles + two quads split in two
    assert mesh.num_triangles == 6
    np.testing.assert_array_equal(mesh.tri_vertices[0], v[[2, 0, 1]])
    np.testing.assert_array_equal(mesh.tri_vertices[2], v[[4, 5, 6]])
    np.testing.assert_array_equal(mesh.tri_vertices[3], v[[4, 6, 7]])
    assert np.isfinite(mesh.tri_vertices).all()


def test_tester_headerless(tester_path):
    """Headerless fixture format: counts on the first two lines, then
    x y z nx ny nz vertex lines and quad faces."""
    v, quads = fixture_tester_grid()
    mesh = ply.load_mesh(tester_path)
    assert mesh.vertices.shape == ((TESTER_LAT + 1) * (TESTER_LON + 1), 3)
    np.testing.assert_allclose(mesh.vertices, v, rtol=1e-7)
    assert mesh.num_triangles == 2 * len(quads)
    # quads split (A,B,C)+(A,C,D): the same soup procgen builds
    np.testing.assert_allclose(
        mesh.tri_vertices,
        procgen.uv_sphere(TESTER_LAT, TESTER_LON, **TESTER_ARGS),
        rtol=1e-7)


def test_quad_split(tmp_path):
    # quads split (A,B,C)+(A,C,D) per read_ply.cpp:70-125
    content = """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
4 0 1 2 3
"""
    p = tmp_path / "quad.ply"
    p.write_text(content)
    mesh = ply.load_mesh(str(p))
    assert mesh.num_triangles == 2
    v = mesh.vertices
    np.testing.assert_allclose(mesh.tri_vertices[0], v[[0, 1, 2]])
    np.testing.assert_allclose(mesh.tri_vertices[1], v[[0, 2, 3]])


def test_write_read_roundtrip(tmp_path):
    """write_ply -> read_ply is exact in both encodings."""
    v, faces = indexed(procgen.uv_sphere(4, 6, roughness=0.1, seed=2))
    for binary in (False, True):
        p = tmp_path / f"rt_{binary}.ply"
        ply.write_ply(p, v, faces, binary=binary)
        mesh = ply.read_ply(p)
        np.testing.assert_array_equal(mesh.vertices, v)
        np.testing.assert_array_equal(mesh.tri_vertices,
                                      v[faces[:, [2, 0, 1]]])
