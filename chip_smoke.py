#!/usr/bin/env python
"""Smoke test of the main path on one NVIDIA GPU, at the headline size.

    python chip_smoke.py          # one card: the phases below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, for each benchmark scene (utils/scenes.py: dragon-class and
clustered, ~800k triangles at 960x540, method="bin"):

- forward frame through `render`: compile time, step time, and full-image
  agreement of the winning triangle ids with the brute-force `fixed`
  oracle at Precision.HIGHEST (>= 0.9999; misses are epsilon flips,
  exact-t ties and back faces the cull drops), with the largest |dt|
  where the ids agree;
- fwd+bwd step: gradients over every scene parameter and the camera, all
  finite; the shading gather's VJP (XLA's scatter-add transpose of
  `jnp.take`) at the frame's hit indices against a float64 host segment
  sum (rtol 1e-4: scatter atomics reorder the sums);
- a few optax steps of `make_train_step(..., mesh=None)` from perturbed
  lighting toward the scene's own frame; the loss must fall.

Then the compiled bin kernel against the same kernel in the Pallas
interpreter at a reduced size (identical winners), and `render_cli` on a
procedural mesh written as a PLY file.

With --four, only: the sharded train step on a 4-device mesh against the
same step on one device (loss rtol 1e-5, updated parameters rtol 1e-4),
and the rays x prims bin render on a 2x2 mesh against the one-device frame
(identical triangle ids).

No phase catches its own failure. Exits non-zero without a GPU. The last
line of stdout is {"ok": true, "device": {...}}; every earlier result line
carries the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

CARD = ""


def report(phase: str, **values) -> None:
    fields = " ".join(f"{k}={v}" for k, v in values.items())
    print(f"[{CARD}] {phase}: {fields}", flush=True)


def timed_first(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def step_ms(fn, *args, n: int = 5) -> float:
    from cpp_cuda_raytracer_dev_tpu.utils.profiling import call_times
    return statistics.median(call_times(fn, *args, n=n)) * 1e3


def check_scene(name: str, num_tris: int = 800_000, width: int = 960,
                height: int = 540) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from cpp_cuda_raytracer_dev_tpu.models.renderer import render
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        make_train_step)
    from cpp_cuda_raytracer_dev_tpu.utils.scenes import (bench_scene,
                                                         oracle_hits)

    scene, camera, config = bench_scene(name, num_tris, width, height)
    n_tris = scene.objects[0].tris.num_triangles

    # --- forward frame vs the HIGHEST-precision oracle ---
    fwd = jax.jit(lambda s, c: render(s, c, config))
    out, compile_s = timed_first(fwd, scene, camera)
    ms = step_ms(fwd, scene, camera)
    t_ref, tri_ref = oracle_hits(scene, camera, config)
    tri = np.asarray(out.hit_tri).reshape(-1)
    t = np.asarray(out.hit_t).reshape(-1)
    agree = float(np.mean(tri == tri_ref))
    same = (tri == tri_ref) & (tri >= 0)
    max_dt = float(np.max(np.abs(t[same] - t_ref[same])))
    hit_rate = float(np.mean(tri_ref >= 0))
    report(f"{name} forward", tris=n_tris, res=f"{width}x{height}",
           compile_s=f"{compile_s:.1f}", step_ms=f"{ms:.3f}",
           agree_full=f"{agree:.6f}", max_abs_dt=f"{max_dt:.3e}",
           hit_rate=f"{hit_rate:.4f}")
    assert out.image.shape == (height, width, 3)
    assert agree >= 0.9999, f"{name}: agree_full {agree} < 0.9999"

    # --- fwd+bwd over all scene parameters and the camera ---
    w = jnp.linspace(0.3, 1.7, width * height * 3).reshape(height, width, 3)

    def grads_fn(cfg):
        def loss(s, c):
            return jnp.mean(render(s, c, cfg).radiance * w)
        return jax.jit(jax.grad(loss, argnums=(0, 1)))

    fwd_bwd = grads_fn(config)
    g, compile_s = timed_first(fwd_bwd, scene, camera)
    ms = step_ms(fwd_bwd, scene, camera)
    finite = all(bool(jnp.all(jnp.isfinite(x))) for x in jax.tree.leaves(g))
    vjp_err = check_gather_vjp(scene, tri)
    report(f"{name} fwd+bwd", compile_s=f"{compile_s:.1f}",
           step_ms=f"{ms:.3f}", grads_finite=finite,
           gather_vjp_max_rel_err=f"{vjp_err:.3e}")
    assert finite, f"{name}: non-finite gradients"

    # --- a few trainer steps toward the scene's own frame ---
    target = out.radiance
    p = scene.phong
    start = scene.replace(phong=p.replace(
        light_pos=p.light_pos + jnp.array([0.6, -0.4, 0.5]),
        diffuse=p.diffuse * 0.7))
    params = {"scene": start, "camera": camera}
    labels = jax.tree.map(lambda _: "frozen", params)
    labels["scene"] = labels["scene"].replace(
        phong=jax.tree.map(lambda _: "fit", start.phong))
    opt = optax.multi_transform(
        {"fit": optax.adam(0.05), "frozen": optax.set_to_zero()}, labels)
    step = jax.jit(make_train_step(opt, config, None))
    state = opt.init(params)
    losses = []
    t0 = time.perf_counter()
    for _ in range(6):
        params, state, loss = step(params, state, target)
        losses.append(float(loss))
    report(f"{name} train", steps=len(losses),
           wall_s_incl_compile=f"{time.perf_counter() - t0:.1f}",
           losses=",".join(f"{x:.6g}" for x in losses))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def check_gather_vjp(scene, hit_tri: np.ndarray) -> float:
    """The shading gather's VJP (XLA's scatter-add transpose of
    `jnp.take`, ops of models/renderer.py shade_hits) at the frame's real
    hit indices, against a float64 segment sum on the host. Atomics
    reorder the sums, hence rtol 1e-4. Returns the max relative error."""
    import jax
    import jax.numpy as jnp

    t = scene.objects[0].tris
    table = jnp.concatenate(
        [jnp.stack([t.p1x, t.p1y, t.p1z, t.e1x, t.e1y, t.e1z,
                    t.e2x, t.e2y, t.e2z], axis=1), t.color], axis=1)
    idx = np.maximum(hit_tri, 0).astype(np.int32)
    ct = np.random.default_rng(0).standard_normal(
        (idx.size, table.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda tab: jnp.take(tab, idx, axis=0), table)
    got = np.asarray(jax.jit(vjp)(jnp.asarray(ct))[0])
    want = np.zeros(table.shape, np.float64)
    np.add.at(want, idx, ct.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def check_kernel_compiled_vs_interpret() -> None:
    import jax.numpy as jnp

    from cpp_cuda_raytracer_dev_tpu.accel.binning import bin_triangles
    from cpp_cuda_raytracer_dev_tpu.accel.traverse import _ray_table
    from cpp_cuda_raytracer_dev_tpu.ops.pallas.bin_intersect import (
        bin_intersect)
    from cpp_cuda_raytracer_dev_tpu.utils.scenes import bench_scene

    scene, camera, config = bench_scene("dragon-class", 20_000, 128, 64)
    tris = scene.objects[0].tris
    th, tw = config.tile_h, config.tile_w
    n_tx, n_tiles = 128 // tw, (64 // th) * (128 // tw)
    proj = camera.projection()
    v = np.asarray(tris.vertices()).reshape(-1, 3)
    rays = _ray_table(proj, camera.pos, jnp.asarray(v.min(0)),
                      jnp.asarray(v.max(0)), n_tiles, n_tx, th, tw,
                      config.draw_distance)
    b = bin_triangles(proj, camera.pos, tris.p1, tris.e1, tris.e2, 64, 128,
                      th, tw, e_cap=4 * 20_000, chunk=config.bin_chunk)
    kw = dict(p=th * tw, chunk=config.bin_chunk)
    t_c, tri_c = bin_intersect(b.starts, rays, b.geom, **kw)
    t_i, tri_i = bin_intersect(b.starts, rays, b.geom, **kw, interpret=True)
    tri_c, tri_i = np.asarray(tri_c), np.asarray(tri_i)
    same = float(np.mean(tri_c == tri_i))
    max_dt = float(np.max(np.abs(np.asarray(t_c) - np.asarray(t_i))))
    report("bin kernel compiled vs interpret", rays=tri_c.size,
           hits=int((tri_c >= 0).sum()), winners_identical=same == 1.0,
           max_abs_dt=f"{max_dt:.3e}")
    assert same == 1.0, f"compiled/interpret winners differ: {same}"


def check_render_cli() -> None:
    from cpp_cuda_raytracer_dev_tpu.apps import render_cli
    from cpp_cuda_raytracer_dev_tpu.io.ply import write_ply
    from cpp_cuda_raytracer_dev_tpu.utils.procgen import uv_sphere_grid

    with tempfile.TemporaryDirectory() as tmp:
        v, quads = uv_sphere_grid(200, 250, roughness=0.03)
        mesh, png = os.path.join(tmp, "mesh.ply"), os.path.join(tmp, "f.png")
        write_ply(mesh, v, quads, binary=True)
        t0 = time.perf_counter()
        render_cli.main(["--mesh", mesh, "--out", png, "--method", "bin"])
        size = os.path.getsize(png)
    report("render_cli", tris=2 * len(quads), png_bytes=size,
           wall_s=f"{time.perf_counter() - t0:.1f}")
    assert size > 0


def check_four(num_tris: int = 800_000, width: int = 960,
               height: int = 540) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from cpp_cuda_raytracer_dev_tpu.models.renderer import render
    from cpp_cuda_raytracer_dev_tpu.parallel.mesh import make_mesh
    from cpp_cuda_raytracer_dev_tpu.parallel.render_pjit import (
        make_train_step, render_sharded_2d_bin)
    from cpp_cuda_raytracer_dev_tpu.utils.scenes import bench_scene

    assert len(jax.devices()) == 4, f"--four needs 4 devices: {jax.devices()}"
    scene, camera, config = bench_scene("dragon-class", num_tris, width,
                                        height)
    p = scene.phong
    target = jax.jit(lambda s, c: render(s, c, config).radiance)(
        scene.replace(phong=p.replace(diffuse=p.diffuse * 0.7)), camera)
    opt = optax.sgd(1e-3)
    params = {"scene": scene, "camera": camera}
    state = opt.init(params)
    step4 = jax.jit(make_train_step(opt, config, make_mesh(4)))
    step1 = jax.jit(make_train_step(opt, config, None))
    (p4, _, loss4), c4 = timed_first(step4, params, state, target)
    (p1, _, loss1), c1 = timed_first(step1, params, state, target)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-5)
    worst = 0.0
    for a, b in zip(jax.tree.leaves(p4), jax.tree.leaves(p1)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
        worst = max(worst, float(np.max(np.abs(a - b))))
    report("four-card train step vs one card", mesh="rays=4",
           loss_4=f"{float(loss4):.8g}", loss_1=f"{float(loss1):.8g}",
           params_max_abs_diff=f"{worst:.3e}",
           step_ms_4=f"{step_ms(step4, params, state, target):.3f}",
           step_ms_1=f"{step_ms(step1, params, state, target):.3f}",
           compile_s_4=f"{c4:.1f}", compile_s_1=f"{c1:.1f}")

    mesh2 = make_mesh(4, prims=2)
    f2 = jax.jit(lambda s, c: render_sharded_2d_bin(s, c, config, mesh2))
    f1 = jax.jit(lambda s, c: render(s, c, config))
    o2, c2 = timed_first(f2, scene, camera)
    o1 = f1(scene, camera)
    tri2, tri1 = np.asarray(o2.hit_tri), np.asarray(o1.hit_tri)
    same = float(np.mean(tri2 == tri1))
    report("2x2 rays x prims bin render vs one card", mesh="rays=2,prims=2",
           hit_tri_agree=f"{same:.6f}", compile_s=f"{c2:.1f}",
           step_ms_2x2=f"{step_ms(f2, scene, camera):.3f}",
           step_ms_1=f"{step_ms(f1, scene, camera):.3f}")
    assert same == 1.0, f"2x2 bin render differs from one card: {same}"


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args()

    import jax

    import cpp_cuda_raytracer_dev_tpu  # noqa: F401  (fails outside the repo)
    if jax.default_backend() != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2
    from cpp_cuda_raytracer_dev_tpu.utils.compile_cache import (
        setup_compile_cache)
    cache = setup_compile_cache()

    from cpp_cuda_raytracer_dev_tpu.utils.profiling import gpu_cards
    smi = gpu_cards()
    print(smi, flush=True)
    cards = smi.splitlines()
    CARD = cards[0] if len(set(cards)) == 1 else "; ".join(cards)
    devs = jax.devices()
    report("devices", n=len(devs), kind=devs[0].device_kind,
           jax=jax.__version__, compile_cache=cache)

    t0 = time.perf_counter()
    if args.four:
        check_four()
    else:
        from cpp_cuda_raytracer_dev_tpu.utils.scenes import SCENES
        for name in SCENES:
            check_scene(name)
        check_kernel_compiled_vs_interpret()
        check_render_cli()
    report("total", wall_s=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
