"""Finite-difference validation of the differentiable render path
(BASELINE.json: "gradients allclose vs FD"; SURVEY.md §7 step 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpp_cuda_raytracer_dev_tpu import (Camera, PhongParams, RenderConfig,
                                        Scene, SceneObject, Triangles, render)
from cpp_cuda_raytracer_dev_tpu.ops.quaternion import Pose, from_axis_angle

CFG = RenderConfig(method="fixed", chunk=8)


def build(params, simple_tris):
    """Rebuild the scene from raw parameters so grads flow to them."""
    tris = Triangles.from_vertices(params["verts"])
    pose = Pose(quat=params["quat"], translation=params["trans"])
    phong = PhongParams(
        light_pos=params["light_pos"],
        light_color=jnp.ones(3), diffuse=params["diffuse"],
        specular=jnp.asarray(0.3), exponent=jnp.asarray(5.0))
    scene = Scene.create([SceneObject.create(tris, pose)], phong)
    cam = Camera.create(
        12, 12, pos=params["cam_pos"], look_at=[0.0, 0.0, 0.0],
        up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.01)
    return scene, cam


def loss(params, simple_tris, mask=None):
    scene, cam = build(params, simple_tris)
    out = render(scene, cam, CFG)
    # weighted mean so the gradient isn't uniform across pixels
    w = jnp.linspace(0.3, 1.7, 12 * 12 * 3).reshape(12, 12, 3)
    rad = out.radiance * w
    if mask is not None:
        rad = rad * mask[..., None]
    return jnp.mean(rad)


def interior_mask(params, simple_tris):
    """Pixels whose 3x3 hit-triangle neighborhood is uniform: away from
    silhouettes, so hit topology is stable under small FD probes and the
    fixed-topology analytic gradient (stop_gradient on selection) is the
    true derivative of the masked loss."""
    scene, cam = build(params, simple_tris)
    tri = np.asarray(render(scene, cam, CFG).hit_tri)
    ok = tri >= 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= np.roll(np.roll(tri, dy, 0), dx, 1) == tri
    ok[0, :] = ok[-1, :] = False
    ok[:, 0] = ok[:, -1] = False
    return jnp.asarray(ok.astype(np.float32))


@pytest.fixture(scope="module")
def params(simple_tris):
    return {
        "verts": jnp.asarray(simple_tris),
        "quat": from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.1),
        "trans": jnp.array([0.02, -0.01, 0.0]),
        "light_pos": jnp.array([2.0, 2.0, 2.0]),
        "diffuse": jnp.asarray(0.6),
        "cam_pos": jnp.array([0.0, 0.0, -1.0]),
    }


def fd_grad(f, x, eps):
    """Central differences on a flat float64 copy of one leaf."""
    flat = np.asarray(x, np.float64).ravel()
    g = np.zeros_like(flat)
    for i in range(flat.size):
        for s, sign in ((eps, 1.0), (-eps, -1.0)):
            p = flat.copy()
            p[i] += s
            g[i] += sign * float(f(p.reshape(np.shape(x)).astype(np.float32)))
    return (g / (2 * eps)).reshape(np.shape(x))


@pytest.mark.parametrize("leaf,eps,tol,masked", [
    ("light_pos", 1e-3, 2e-2, False),
    ("diffuse", 1e-3, 2e-2, False),
    # pose/camera gradients are interior-only at fixed topology by design
    # (stop_gradient on hit selection, models/renderer.py), so the FD loss
    # is masked to silhouette-free pixels — there the analytic gradient is
    # exact and the tolerance is tight.
    ("trans", 5e-4, 1e-2, True),
    ("cam_pos", 1e-4, 1e-2, True),
])
def test_grad_matches_fd(params, simple_tris, leaf, eps, tol, masked):
    mask = interior_mask(params, simple_tris) if masked else None
    grad = jax.grad(loss)(params, simple_tris, mask)[leaf]
    jl = jax.jit(lambda v: loss({**params, leaf: v}, simple_tris, mask))
    f = lambda v: jl(jnp.asarray(v))
    fd = fd_grad(f, params[leaf], eps)
    denom = np.maximum(np.abs(fd), np.max(np.abs(fd)) * 1e-2 + 1e-8)
    rel = np.abs(np.asarray(grad, np.float64) - fd) / denom
    assert np.nanmax(rel) < tol, (leaf, grad, fd)


def test_grad_vertices_nonzero_and_fd(params, simple_tris):
    grad = jax.grad(loss)(params, simple_tris)["verts"]
    assert np.abs(np.asarray(grad)).max() > 0
    # FD spot-check a handful of coordinates of the front square
    jl = jax.jit(lambda v: loss({**params, "verts": v}, simple_tris))
    f = lambda v: jl(jnp.asarray(v))
    flat = np.asarray(params["verts"], np.float64).copy()
    eps = 1e-4
    for idx in [(0, 0, 0), (0, 1, 2), (1, 2, 1)]:
        p_hi = flat.copy(); p_hi[idx] += eps
        p_lo = flat.copy(); p_lo[idx] -= eps
        fd = (float(f(p_hi.astype(np.float32)))
              - float(f(p_lo.astype(np.float32)))) / (2 * eps)
        g = float(grad[idx])
        assert abs(g - fd) <= 0.05 * max(abs(fd), abs(g), 1e-3), (idx, g, fd)


def test_quaternion_grad_exists(params, simple_tris):
    g = jax.grad(loss)(params, simple_tris)["quat"]
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0
