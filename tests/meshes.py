"""Seeded mesh fixtures, written as PLY files in each format io/ply.py
reads, and the golden-frame render they feed (tests/golden).

- tester: the headerless fixture format (``read_tester``), a roughened
  closed quad sphere (quads exercise the quad split);
- rabbit: ASCII PLY with bare ``element`` lines and two extra vertex
  columns, a clustered-density closed mesh;
- walls: binary little-endian PLY with per-vertex normals and mixed
  triangle/quad faces, three walls of a room.
"""

from __future__ import annotations

import numpy as np

from cpp_cuda_raytracer_dev_tpu.io.ply import write_ply
from cpp_cuda_raytracer_dev_tpu.utils import procgen

TESTER_LAT, TESTER_LON = 15, 30
TESTER_ARGS = dict(roughness=0.05, seed=11)
RABBIT_ARGS = dict(num_tris=6_000, seed=5, blobs=6)


def indexed(soup: np.ndarray):
    """(T, 3, 3) triangle soup -> (unique vertices, (T, 3) faces)."""
    v, inv = np.unique(soup.reshape(-1, 3), axis=0, return_inverse=True)
    return v.astype(np.float32), inv.reshape(-1, 3)


def fixture_tester_grid():
    return procgen.uv_sphere_grid(TESTER_LAT, TESTER_LON, **TESTER_ARGS)


def rabbit_indexed():
    return indexed(procgen.clustered_mesh(**RABBIT_ARGS))


def walls_mesh():
    """Three walls of a room (back, left, right): 12 vertices with
    normals, the back wall as two triangles, the side walls as quads."""
    v = np.array([
        [-1, 0, 1], [1, 0, 1], [1, 2, 1], [-1, 2, 1],          # back
        [-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1],      # left
        [1, 0, 1], [1, 0, -1], [1, 2, -1], [1, 2, 1],          # right
    ], np.float32)
    nrm = np.repeat(np.array([[0, 0, -1], [1, 0, 0], [-1, 0, 0]],
                             np.float32), 4, axis=0)
    faces = [[0, 1, 2], [0, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    return v, nrm, faces


def write_tester(path) -> None:
    """Headerless fixture format: vertex count, face count, then
    ``x y z nx ny nz`` vertex lines and ``n i j k ...`` face lines."""
    v, faces = fixture_tester_grid()
    nrm = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    lines = [str(len(v)), str(len(faces))]
    lines += [" ".join(f"{x:.9g}" for x in row)
              for row in np.concatenate([v, nrm], axis=1)]
    lines += [" ".join(map(str, [len(f), *f])) for f in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_rabbit(path) -> None:
    v, faces = rabbit_indexed()
    rng = np.random.default_rng(RABBIT_ARGS["seed"])
    extra = rng.random((len(v), 2)).astype(np.float32)  # conf, intensity
    write_ply(path, v, faces, extra=extra, declare_properties=False)


def write_walls(path) -> None:
    v, nrm, faces = walls_mesh()
    write_ply(path, v, faces, binary=True, extra=nrm)


def render_golden(mesh_path, res_w: int, res_h: int, method: str, **kw):
    """uint8 frame of a mesh file from the golden camera (oblique, above
    and in front of the mesh's bounding-box centre)."""
    from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                            SceneObject, Triangles, render)
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import ClusterAccel
    from cpp_cuda_raytracer_dev_tpu.io import ply

    mesh = ply.load_mesh(mesh_path)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    scene = Scene.create([SceneObject.create(tris)])
    v = mesh.tri_vertices.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    cam = Camera.create(
        res_w, res_h,
        pos=center + np.array([0.15 * size, 0.2 * size, -1.2 * size]),
        look_at=center, up=[0, 1, 0], film_h=0.024, focal=0.055)
    accel = None
    if method == "grid":
        accel = (ClusterAccel.build(tris, leaf_size=kw.get("leaf_size", 32)),)
    cfg = RenderConfig(method=method, draw_distance=max(400.0, 10 * size),
                       **kw)
    return np.asarray(render(scene, cam, cfg, accel=accel).image)
