"""The per-tile bin kernel (ops/pallas/bin_intersect.py) in interpret mode
against the brute-force oracle, and its wrapper.

Every case bins a seeded procedural mesh with accel/binning.py, runs the
kernel, and compares each pixel's winner with `mt_brute` over the same
rays the kernel generates."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                        SceneObject, Triangles)
from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles
from cpp_cuda_raytracer_dev_tpu.accel.traverse import (_ray_table,
                                                       intersect_binned)
from cpp_cuda_raytracer_dev_tpu.models.renderer import trace_rays
from cpp_cuda_raytracer_dev_tpu.ops.intersect import mt_brute
from cpp_cuda_raytracer_dev_tpu.ops.pallas.bin_intersect import (
    bin_intersect, interpret_default)
from cpp_cuda_raytracer_dev_tpu.utils.procgen import dragon_class_mesh

TH, TW = 8, 16
P = TH * TW


def _setup(res_w=64, res_h=32, n_tris=2000, pos=(0.0, 0.0, -3.0),
           focal=0.055):
    tris = Triangles.from_vertices(dragon_class_mesh(n_tris, seed=3))
    cam = Camera.create(res_w, res_h, pos=list(pos), look_at=[0, 0, 0],
                        up=[0, 1, 0], film_h=0.024, focal=focal)
    return tris, cam


def _binned_inputs(tris, cam, chunk, e_cap=None):
    res_h, res_w = cam.res_h, cam.res_w
    assert res_h % TH == 0 and res_w % TW == 0
    n_tx = res_w // TW
    n_tiles = (res_h // TH) * n_tx
    proj = cam.projection()
    o = jnp.asarray(cam.pos)
    v = np.asarray(tris.vertices()).reshape(-1, 3)
    rays = _ray_table(proj, o, jnp.asarray(v.min(0)), jnp.asarray(v.max(0)),
                      n_tiles, n_tx, TH, TW, 400.0)
    binned = bin_triangles(proj, o, tris.p1, tris.e1, tris.e2,
                           res_h, res_w, TH, TW,
                           e_cap=e_cap or 8 * tris.num_triangles + 4096,
                           chunk=chunk)
    return rays, binned


def _oracle(tris, cam, rays):
    d = jnp.asarray(rays[:3].T)
    return mt_brute(jnp.asarray(cam.pos), d, tris, 400.0, chunk=512)


def _check_vs_oracle(t, tri, ref, min_agree=0.999):
    """Winners agree except on exact-t ties (rays through an edge two
    triangles share, where either id is right); hit distances agree."""
    t, tri = np.asarray(t), np.asarray(tri)
    rt, rtri = np.asarray(ref.t), np.asarray(ref.tri)
    assert (rtri >= 0).any() and (rtri < 0).any()
    tie = (tri >= 0) & (rtri >= 0) & (np.abs(t - rt) <= 1e-5 * rt)
    agree = ((tri == rtri) | tie).mean()
    assert agree >= min_agree, f"agreement {agree}"
    m = (tri == rtri) & (rtri >= 0)
    np.testing.assert_allclose(t[m], rt[m], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t[rtri < 0], 400.0)


def test_interpret_only_on_cpu():
    assert interpret_default() == (jax.default_backend() == "cpu")


@pytest.mark.parametrize("chunk,n_sub", [(8, 1), (16, 4), (64, 2)])
def test_kernel_matches_brute(chunk, n_sub):
    """Segments cross many chunk boundaries at chunk=8 (starts are not
    chunk-aligned) and fit one chunk at 64; n_sub splits each tile's rays
    over several programs."""
    tris, cam = _setup()
    rays, binned = _binned_inputs(tris, cam, chunk)
    starts = np.asarray(binned.starts)
    seg = np.diff(starts)
    assert seg.max() > 4 * chunk or chunk == 64
    assert (starts[:-1] % chunk != 0).any()
    t, tri = bin_intersect(binned.starts, rays, binned.geom, p=P,
                           n_sub=n_sub, chunk=chunk, interpret=True)
    _check_vs_oracle(t, tri, _oracle(tris, cam, rays))


def test_kernel_empty_tiles():
    """A small far-away mesh leaves most tiles with empty bins; their rays
    must come back as misses, and an all-empty table must work too."""
    tris, cam = _setup(pos=(0.0, 0.0, -12.0))
    rays, binned = _binned_inputs(tris, cam, 16)
    seg = np.diff(np.asarray(binned.starts))
    assert (seg == 0).sum() > seg.size // 2 and (seg > 0).any()
    t, tri = bin_intersect(binned.starts, rays, binned.geom, p=P,
                           n_sub=2, chunk=16, interpret=True)
    _check_vs_oracle(t, tri, _oracle(tris, cam, rays))

    empty = jnp.zeros_like(binned.starts)
    t0, tri0 = bin_intersect(empty, rays, binned.geom, p=P, n_sub=2,
                             chunk=16, interpret=True)
    np.testing.assert_array_equal(np.asarray(tri0), -1)
    np.testing.assert_array_equal(np.asarray(t0), 400.0)


def test_kernel_early_exit_stops_scan():
    """The exit test reads the certificate row: with every certificate
    after each tile's first chunk raised past the scene, the kernel must
    stop after one chunk — so a nearer hit planted later is never seen —
    while with the true certificates it finds the oracle's winners."""
    tris, cam = _setup()
    chunk = 8
    rays, binned = _binned_inputs(tris, cam, chunk)
    starts = np.asarray(binned.starts)
    geom = np.asarray(binned.geom).copy()
    col = np.arange(geom.shape[1])
    tile_of = np.searchsorted(starts, col, side="right") - 1
    tile_of = np.clip(tile_of, 0, len(starts) - 2)
    later = col >= starts[tile_of] + chunk
    geom[10, later] = 1.0e30
    t_cut, tri_cut = bin_intersect(binned.starts, rays, jnp.asarray(geom),
                                   p=P, n_sub=1, chunk=chunk,
                                   interpret=True)
    # reference: only each tile's first chunk is ever scanned
    first = np.asarray(binned.geom).copy()
    first[:10, later] = 0.0                            # det = 0: no hit
    t_ref, tri_ref = bin_intersect(binned.starts, rays, jnp.asarray(first),
                                   p=P, n_sub=1, chunk=chunk,
                                   interpret=True)
    np.testing.assert_array_equal(np.asarray(tri_cut), np.asarray(tri_ref))
    t_all, tri_all = bin_intersect(binned.starts, rays, binned.geom, p=P,
                                   n_sub=1, chunk=chunk, interpret=True)
    assert (np.asarray(tri_all) != np.asarray(tri_cut)).any()
    _check_vs_oracle(t_all, tri_all, _oracle(tris, cam, rays))


@pytest.mark.parametrize("chunk,n_sub", [(16, 16), (32, 4), (8, 2)])
def test_kernel_launch_shape_invariant(chunk, n_sub):
    """The launch shape (entries per step, programs per tile) changes how
    the work is split, never a winner."""
    tris, cam = _setup()
    rays, binned = _binned_inputs(tris, cam, 32)
    t0, tri0 = bin_intersect(binned.starts, rays, binned.geom, p=P,
                             n_sub=1, chunk=32, interpret=True)
    t, tri = bin_intersect(binned.starts, rays, binned.geom, p=P,
                           n_sub=n_sub, chunk=chunk, interpret=True)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(tri0))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t0))


def test_exact_ties_pick_smallest_id():
    """Every triangle duplicated: each hit is an exact-t tie between ids i
    and i + T, found in different chunks (the copies sort apart); the
    kernel must return the smaller id, as the oracle does."""
    tris, cam = _setup()
    soup = np.asarray(tris.vertices())
    n = soup.shape[0]
    twice = Triangles.from_vertices(np.concatenate([soup[::-1], soup]))
    rays, binned = _binned_inputs(twice, cam, 8)
    t, tri = bin_intersect(binned.starts, rays, binned.geom, p=P, n_sub=2,
                           chunk=8, interpret=True)
    tri = np.asarray(tri)
    assert (tri >= 0).any()
    assert (tri[tri >= 0] < n).all()
    ref = _oracle(twice, cam, rays)
    np.testing.assert_array_equal(tri, np.asarray(ref.tri))


def test_kernel_rejects_bad_shapes():
    tris, cam = _setup()
    rays, binned = _binned_inputs(tris, cam, 16)
    with pytest.raises(ValueError, match="powers of two"):
        bin_intersect(binned.starts, rays, binned.geom, p=P, n_sub=3,
                      chunk=16, interpret=True)
    with pytest.raises(ValueError, match="powers of two"):
        bin_intersect(binned.starts, rays, binned.geom, p=P, n_sub=2,
                      chunk=24, interpret=True)
    with pytest.raises(ValueError, match="tiles"):
        bin_intersect(binned.starts[:-1], rays, binned.geom, p=P, n_sub=2,
                      chunk=16, interpret=True)


def _trace(tris, cam, **kw):
    scene = Scene.create([SceneObject.create(tris)])
    cfg = RenderConfig(method="bin", tile_h=TH, tile_w=TW, **kw)
    return trace_rays(scene, cam.pos, cam.ray_directions(), cfg, None,
                      cam.res_h, cam.res_w, proj=cam.projection())


@pytest.mark.parametrize("res", [(60, 30), (64, 32), (47, 21)])
def test_wrapper_pads_partial_tiles(res):
    """Resolutions that are not whole tiles: the wrapper pads the tile
    grid and crops back; every real pixel matches the oracle."""
    tris, cam = _setup(*res)
    hit = _trace(tris, cam, bin_chunk=16)
    ref = mt_brute(jnp.asarray(cam.pos), cam.ray_directions(), tris, 400.0,
                   chunk=512)
    assert hit.tri.shape == (res[0] * res[1],)
    _check_vs_oracle(hit.t, hit.tri, ref)


def test_overflow_escalation_recovers():
    """An entry table too small for the frame overflows; the 2x re-bin
    must recover every hit, and without escalation the overflow must be
    reported."""
    tris, cam = _setup(n_tris=20_000)
    ref = mt_brute(jnp.asarray(cam.pos), cam.ray_directions(), tris, 400.0,
                   chunk=512)
    # e_cap = 0 * T + 8192 entries, below what this frame needs
    base = dict(bin_chunk=16, bin_e_factor=0.0)
    scene = Scene.create([SceneObject.create(tris)])
    cfg = RenderConfig(method="bin", tile_h=TH, tile_w=TW, with_stats=True,
                       bin_escalate=False, **base)
    hit_drop, stats = intersect_binned(
        jnp.asarray(cam.pos), cam.ray_directions(), scene.objects[0].tris,
        cam.projection(), cfg, cam.res_h, cam.res_w)
    assert int(stats["overflow"]) > 0
    assert int(stats["entries"]) == 8192            # clamped at e_cap
    assert (np.asarray(hit_drop.tri) != np.asarray(ref.tri)).any()

    cfg = dataclasses.replace(cfg, bin_escalate=True)
    hit, stats = intersect_binned(
        jnp.asarray(cam.pos), cam.ray_directions(), scene.objects[0].tris,
        cam.projection(), cfg, cam.res_h, cam.res_w)
    assert int(stats["overflow"]) == 0
    _check_vs_oracle(hit.t, hit.tri, ref)


@pytest.mark.gpu
def test_compiled_matches_interpret(gpu):
    """On a GPU: the compiled Triton kernel and the same kernel in the
    interpreter pick identical winners."""
    tris, cam = _setup(128, 64, n_tris=20_000)
    rays, binned = _binned_inputs(tris, cam, 32)
    kw = dict(p=P, n_sub=2, chunk=32)
    t_c, tri_c = bin_intersect(binned.starts, rays, binned.geom, **kw)
    t_i, tri_i = bin_intersect(binned.starts, rays, binned.geom, **kw,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(tri_c), np.asarray(tri_i))
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_i), rtol=1e-6)
