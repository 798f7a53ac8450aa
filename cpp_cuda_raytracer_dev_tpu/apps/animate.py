"""Offline animation driver — the frame loop of WinMain, headless.

Replays a key script (models/animation.py) through the jitted renderer,
writing PNG frames and printing the reference's HUD block (resolution, FPS,
camera basis — WinMain.cpp:225-234) in place via VT escapes.

Usage:
    python -m cpp_cuda_raytracer_dev_tpu.apps.animate \
        --mesh mesh.ply --out frames --res 512 288 --frames 60
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", required=True)
    p.add_argument("--out", default=None, help="frame output dir (PNG)")
    p.add_argument("--res", type=int, nargs=2, default=[480, 270])
    p.add_argument("--frames", type=int, default=0,
                   help="cap on total frames (0 = full script)")
    p.add_argument("--method", default="bin",
                   help="intersect backend; 'bin' is the main path "
                        "(screen-space binning + per-tile kernel)")
    p.add_argument("--leaf-size", type=int, default=128)
    p.add_argument("--json-out", default=None,
                   help="write a JSON artifact with the steady-state "
                        "frame time after the run")
    p.add_argument("--max-candidates", type=int, default=32)
    p.add_argument("--second-object", action="store_true",
                   help="add a second posed instance of the mesh "
                        "(multi-mesh demo, WinMain.cpp:152-156)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from .. import (Camera, RenderConfig, Scene, SceneObject, Triangles,
                    render)
    from ..accel.traverse import ClusterAccel
    from ..io import ply
    from ..models.animation import demo_script, run_script
    from ..ops.quaternion import Pose, from_axis_angle
    from ..utils.image import Hud, write_png

    mesh = ply.load_mesh(args.mesh)
    tris = Triangles.from_vertices(mesh.tri_vertices)
    lo = mesh.tri_vertices.reshape(-1, 3).min(0)
    hi = mesh.tri_vertices.reshape(-1, 3).max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))

    objects = [SceneObject.create(tris)]
    if args.second_object:
        pose = Pose(
            quat=from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.8),
            translation=jnp.asarray([size * 0.6, 0.0, size * 0.2],
                                    jnp.float32))
        objects.append(SceneObject.create(tris, pose))
    scene = Scene.create(objects)

    w, h = args.res
    camera = Camera.create(
        w, h, pos=center + np.array([0, 0.1 * size, -1.2 * size]),
        look_at=center, up=[0, 1, 0], film_h=0.024, focal=0.035)
    config = RenderConfig(method=args.method, leaf_size=args.leaf_size,
                          max_candidates=args.max_candidates,
                          draw_distance=max(400.0, 10 * size))
    accel = None
    if args.method == "grid":
        accel = tuple(ClusterAccel.build(o.tris, args.leaf_size)
                      for o in scene.objects)

    frame_fn = jax.jit(lambda s, c: render(s, c, config, accel).image)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    hud = Hud()
    n, u, v = camera.basis()
    t_prev = time.perf_counter()
    total = 0
    for tick, key, scene in run_script(scene, camera, demo_script()):
        img = np.asarray(jax.block_until_ready(frame_fn(scene, camera)))
        t_now = time.perf_counter()
        fps = 1.0 / max(t_now - t_prev, 1e-9)
        t_prev = t_now
        if args.out:
            write_png(os.path.join(args.out, f"frame_{tick:04d}.png"), img)
        hud.update([
            f"Resolution: {w} x {h}",
            f"Key: {key}   Frame: {tick}",
            f"wall-FPS (incl. host transfer): {fps:.2f}",
            f"CameraPos [x:{float(camera.pos[0]):.4f} "
            f"y:{float(camera.pos[1]):.4f} z:{float(camera.pos[2]):.4f}]",
            f"Camera N [x:{float(n[0]):.4f} y:{float(n[1]):.4f} "
            f"z:{float(n[2]):.4f}]",
            f"Camera U [x:{float(u[0]):.4f} y:{float(u[1]):.4f} "
            f"z:{float(u[2]):.4f}]",
            f"Camera V [x:{float(v[0]):.4f} y:{float(v[1]):.4f} "
            f"z:{float(v[2]):.4f}]",
        ])
        total += 1
        if args.frames and total >= args.frames:
            break
    print(f"\nrendered {total} frames")

    # steady-state frame time on the final pose, without the per-frame
    # host transfer the HUD FPS above includes
    from ..utils.profiling import call_times
    dt = float(np.median(call_times(frame_fn, scene, camera, n=5)))
    print(f"steady-state frame on {jax.devices()[0].device_kind}: "
          f"{dt * 1e3:.2f} ms ({1.0 / dt:.1f} FPS, {w * h / dt:.3e} rays/s)")
    if args.json_out:
        import json
        with open(args.json_out, "w") as f:
            json.dump({
                "mesh": args.mesh, "method": args.method,
                "resolution": [w, h], "frames": total,
                "device": jax.devices()[0].device_kind,
                "ms_per_frame": dt * 1e3,
                "fps": 1.0 / dt,
                "rays_per_sec": w * h / dt,
            }, f, indent=2)


if __name__ == "__main__":
    main()
