"""Numerical-failure detection (utils/debug.py) — the sanitizer analogue
the reference lacks entirely (SURVEY.md §5: jax_debug_nans / checkify)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, RenderConfig, Scene,
                                        SceneObject, Triangles)
from cpp_cuda_raytracer_dev_tpu.utils.debug import checked_render, debug_nans
from cpp_cuda_raytracer_dev_tpu.utils.procgen import uv_sphere


@pytest.fixture(scope="module")
def tiny_scene():
    tris = Triangles.from_vertices(uv_sphere(16, 16))
    scene = Scene.create([SceneObject.create(tris)])
    camera = Camera.create(32, 24, pos=[0.0, 0.0, -3.0],
                           look_at=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0],
                           film_h=0.024, focal=0.055)
    return scene, camera


def test_checked_render_clean(tiny_scene):
    scene, camera = tiny_scene
    err, frame = checked_render(scene, camera, RenderConfig(method="fixed"))
    assert err.get() is None
    assert np.isfinite(np.asarray(frame.radiance)).all()


def test_checked_render_flags_nan(tiny_scene):
    scene, camera = tiny_scene
    bad = scene.replace(phong=scene.phong.replace(
        light_pos=jnp.array([jnp.nan, 2.0, 2.0])))
    err, _ = checked_render(bad, camera, RenderConfig(method="fixed"))
    assert err.get() is not None       # NaN light position is detected
    with pytest.raises(Exception):
        err.throw()


def test_debug_nans_context(tiny_scene):
    scene, camera = tiny_scene
    with debug_nans():
        # a clean op runs fine under the flag
        _ = jnp.sum(scene.objects[0].tris.p1).block_until_ready()
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / x)(jnp.zeros(4)).block_until_ready()
    assert not jax.config.jax_debug_nans


def test_checked_render_flagship_bin(tiny_scene):
    """checkify composes with the main bin path too (Pallas call is
    opaque to checkify; its outputs are checked by the consuming ops)."""
    scene, camera = tiny_scene
    err, frame = checked_render(scene, camera,
                                RenderConfig(method="bin", bin_chunk=128))
    assert err.get() is None
    assert np.isfinite(np.asarray(frame.radiance)).all()
