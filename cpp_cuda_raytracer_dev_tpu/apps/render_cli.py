"""Single-frame render CLI — load a PLY, render, write an image.

The minimal "WinMain" equivalent: scene setup (WinMain.cpp:69-156) plus one
frame, with the reference's hardcoded choices exposed as flags (SURVEY.md
§5 "Config").

Usage:
    python -m cpp_cuda_raytracer_dev_tpu.apps.render_cli \
        --mesh mesh.ply --out frame.png --res 960 540 --method bin
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", required=True)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--res", type=int, nargs=2, default=[960, 540])
    p.add_argument("--method", default="bin",
                   choices=["brute", "fixed", "grid", "kd", "bin",
                            "raster"])
    p.add_argument("--leaf-size", type=int, default=128)
    p.add_argument("--max-candidates", type=int, default=48)
    p.add_argument("--pos", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--focal", type=float, default=0.055)
    p.add_argument("--color", type=float, nargs=3,
                   default=[0.1, 0.55, 0.20])  # WinMain.cpp:118-120
    args = p.parse_args(argv)

    import jax

    from ..utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from .. import (Camera, RenderConfig, Scene, SceneObject, Triangles,
                    render)
    from ..accel.traverse import ClusterAccel, KDTables
    from ..accel.kd_build import build_kd
    from ..io import ply
    from ..utils.image import write_png

    t0 = time.perf_counter()
    mesh = ply.load_mesh(args.mesh)
    print(f"loaded {mesh.num_triangles} triangles "
          f"in {time.perf_counter() - t0:.2f}s")

    tris = Triangles.from_vertices(
        mesh.tri_vertices, color=np.asarray(args.color, np.float32))
    scene = Scene.create([SceneObject.create(tris)])
    lo = mesh.tri_vertices.reshape(-1, 3).min(0)
    hi = mesh.tri_vertices.reshape(-1, 3).max(0)
    center, size = (lo + hi) / 2, float(np.linalg.norm(hi - lo))
    pos = (np.asarray(args.pos, np.float32) if args.pos
           else center + np.array([0, 0.1 * size, -1.2 * size]))
    look = (np.asarray(args.look_at, np.float32) if args.look_at else center)

    w, h = args.res
    camera = Camera.create(w, h, pos=pos, look_at=look, up=[0, 1, 0],
                           film_h=0.024, focal=args.focal)
    config = RenderConfig(method=args.method, leaf_size=args.leaf_size,
                          max_candidates=args.max_candidates,
                          draw_distance=max(400.0, 10 * size))

    accel = None
    if args.method == "grid":
        t0 = time.perf_counter()
        accel = (ClusterAccel.build(tris, args.leaf_size),)
        print(f"cluster build: {time.perf_counter() - t0:.2f}s "
              f"({accel[0].num_clusters} clusters)")
    elif args.method == "kd":
        t0 = time.perf_counter()
        tree = build_kd(mesh.aabb_min, mesh.aabb_max, args.leaf_size)
        accel = (KDTables.from_tree(tree, tris),)
        print(f"kd build: {time.perf_counter() - t0:.2f}s "
              f"({tree.num_nodes} nodes, depth {tree.max_depth})")

    frame_fn = jax.jit(lambda s, c: render(s, c, config, accel))
    t0 = time.perf_counter()
    out = jax.block_until_ready(frame_fn(scene, camera))
    print(f"first frame (incl. compile): {time.perf_counter() - t0:.2f}s")
    from ..utils.profiling import call_times
    dt = float(np.median(call_times(frame_fn, scene, camera, n=5)))
    print(f"steady-state frame on {jax.devices()[0].device_kind}: "
          f"{dt * 1e3:.2f} ms ({1 / dt:.1f} FPS, {w * h / dt:.3e} rays/s)")

    hit_rate = float(np.mean(np.asarray(out.hit_tri) >= 0))
    print(f"hit rate: {hit_rate:.3f}")
    write_png(args.out, np.asarray(out.image))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
