"""Scatter-min rasterization path (accel/raster.py, method="raster").

Correctness bar: same accept/reject and nearest-hit winner as the
brute-force oracle (ops/intersect.py), including tie-break to the lowest
triangle id — the raster form evaluates the SAME Möller–Trumbore
acceptance through affine-in-pixel constants, so agreement should be
essentially exact, with capacity overflow self-healing (never silent).

This path is a correct small-mesh alternative, not the main path: its
scatter work grows with the projected-bbox pairs (~55M per frame on the
dragon-class mesh).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                        SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_tpu.accel.raster import intersect_raster
from cpp_cuda_raytracer_dev_tpu.io import ply

RES_W, RES_H = 128, 64


@pytest.fixture(scope="module")
def tester(tester_path):
    mesh = ply.load_mesh(tester_path)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    v = mesh.tri_vertices.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    return tris, (lo + hi) / 2, float(np.linalg.norm(hi - lo))


def _camera(center, size, off):
    return Camera.create(RES_W, RES_H, pos=center + np.asarray(off),
                         look_at=center, up=[0, 1, 0], film_h=0.024,
                         focal=0.055)


def _agree(tris, center, size, off, **cfg_kw):
    scene = Scene.create([SceneObject.create(tris)])
    cam = _camera(center, size, np.asarray(off) * size)
    dd = max(400.0, 10 * size)
    ref = render(scene, cam, RenderConfig(method="fixed", chunk=512,
                                          draw_distance=dd))
    out = render(scene, cam, RenderConfig(method="raster",
                                          draw_distance=dd, **cfg_kw))
    rt, bt = np.asarray(ref.hit_tri), np.asarray(out.hit_tri)
    return rt, bt, np.asarray(ref.hit_t), np.asarray(out.hit_t)


@pytest.mark.parametrize("off", [
    (0.0, 0.0, -1.3), (0.5, 0.1, 0.5), (-0.7, 0.4, -0.4)])
def test_raster_matches_oracle(tester, off):
    tris, center, size = tester
    rt, bt, t_ref, t_out = _agree(tris, center, size, off)
    assert (rt >= 0).mean() > 0.05
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree}"
    m = (rt >= 0) & (rt == bt)
    np.testing.assert_allclose(t_out[m], t_ref[m], rtol=3e-4, atol=1e-4)


def test_raster_closeup_overflow_selfheals(tester):
    """A close-up camera routes most triangles past the span cap into the
    overflow pass; with more overflow tris than raster_ovf_cap the old
    code silently dropped geometry — the lax.cond escalation (4x cap)
    must keep the frame exact, and stats must report zero residual."""
    tris, center, size = tester
    # camera very close to the dome: projected spans blow past span=4
    rt, bt, _, _ = _agree(tris, center, size, (0.0, 0.05, -0.18),
                          raster_ovf_cap=32)    # < overflow count, 4x covers
    assert (rt >= 0).mean() > 0.3, "close-up should cover the frame"
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree} (dropped overflow geometry?)"


def test_raster_overflow_stats_loud(tester):
    """Residual overflow past the escalated cap must be counted, never
    silent; with a sane cap it must be zero on the same camera."""
    tris, center, size = tester
    scene = Scene.create([SceneObject.create(tris)])
    cam = _camera(center, size, np.asarray((0.0, 0.05, -0.18)) * size)
    proj = cam.projection()
    d = jnp.asarray(cam.ray_directions())
    cfg = RenderConfig(method="raster", with_stats=True,
                       draw_distance=max(400.0, 10 * size))
    _, stats = intersect_raster(jnp.asarray(cam.pos), d, tris, proj,
                                cfg, RES_H, RES_W)
    assert int(stats["ovf_tris"]) > 64, "camera should stress a tiny cap"
    assert int(stats["overflow"]) == 0, "sane cap must absorb overflow"
    tiny = dataclasses.replace(cfg, raster_ovf_cap=16)
    _, stats2 = intersect_raster(jnp.asarray(cam.pos), d, tris, proj,
                                 tiny, RES_H, RES_W)
    assert int(stats2["overflow"]) > 0, "residual overflow must be loud"


def test_raster_tie_break_lowest_id():
    """Two coplanar overlapping triangles at the same depth: the winner
    must be the LOWEST triangle id (the oracle's argmin semantics)."""
    quad = np.array([
        [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]],
        [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]],
    ], np.float32)
    tris = Triangles.from_vertices(quad)
    cam = Camera.create(32, 32, pos=[0.0, 0.0, 0.0],
                        look_at=[0.0, 0.0, 1.0], up=[0, 1, 0],
                        film_h=0.024, focal=0.055)
    proj = cam.projection()
    d = jnp.asarray(cam.ray_directions())
    cfg = RenderConfig(method="raster")
    hit = intersect_raster(jnp.asarray(cam.pos), d, tris, proj, cfg,
                           32, 32)
    tri = np.asarray(hit.tri)
    assert (tri >= 0).any()
    assert (tri[tri >= 0] == 0).all(), "ties must break to the lowest id"


def test_raster_rabbit_spot(rabbit_path):
    """Real-mesh spot check (rabbit is all small spans — the regime the
    scatter form handles without the overflow pass)."""
    mesh = ply.load_mesh(rabbit_path)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    v = mesh.tri_vertices.reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    rt, bt, _, _ = _agree(tris, center, size, (0.0, 0.0, -1.5))
    assert (rt >= 0).mean() > 0.05
    agree = (rt == bt).mean()
    assert agree > 0.995, f"agreement {agree}"
