#!/usr/bin/env python
"""Benchmark: the main path (method="bin") on one GPU.

Reference bar (BASELINE.md): Stanford dragon ~800k tris @ 960x540, ~100 FPS
forward-only on the author's CUDA GPU => ~5.2e7 primary rays/s. The dragon
PLY is not in the reference repo, so the scenes are seeded procedural
meshes of the same triangle count (utils/scenes.py).

Measures, after warm-up, the forward frame and the fwd+bwd step (gradients
over every scene parameter and the camera), each as the median of
per-call times fenced with `jax.block_until_ready`; checks full-image
agreement with the brute-force oracle (--agree-full) and exits non-zero,
printing no result, when it is below 0.9999.

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}
(vs_baseline > 1.0 means faster than the reference's published forward
number, with ours including the full backward pass). Details go to
BENCH_DETAILS.json and stderr. Refuses to run without a GPU.

    python bench.py [--scene clustered] [--quick] [--no-agree-full]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

REF_RAYS_PER_SEC = 960 * 540 * 100.0  # README.md:19 at 1 ray/pixel


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="dragon-class",
                   choices=["dragon-class", "clustered"])
    p.add_argument("--tris", type=int, default=800_000)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--quick", action="store_true",
                   help="small smoke-test configuration")
    p.add_argument("--agree-full", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="full-image agreement vs the brute-force oracle")
    args = p.parse_args()
    if args.quick:
        args.tris, args.width, args.height = 20_000, 256, 256

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    from cpp_cuda_raytracer_dev_tpu.utils.compile_cache import (
        setup_compile_cache)
    setup_compile_cache()

    from cpp_cuda_raytracer_dev_tpu.accel.traverse import intersect_binned
    from cpp_cuda_raytracer_dev_tpu.models.renderer import render
    from cpp_cuda_raytracer_dev_tpu.utils.profiling import (call_times,
                                                            gpu_cards)
    from cpp_cuda_raytracer_dev_tpu.utils.scenes import (bench_scene,
                                                         oracle_hits)

    dev = jax.devices()[0]
    card_line = gpu_cards()
    log(f"card: {card_line}; jax device {dev.device_kind}")
    scene, camera, config = bench_scene(args.scene, args.tris, args.width,
                                        args.height)
    num_rays = camera.res_w * camera.res_h

    fwd = jax.jit(lambda s, c: render(s, c, config))
    w = jnp.linspace(0.3, 1.7, num_rays * 3).reshape(
        camera.res_h, camera.res_w, 3)

    def loss(s, c):
        return jnp.mean(render(s, c, config).radiance * w)

    fwd_bwd = jax.jit(jax.grad(loss, argnums=(0, 1)))

    t0 = time.perf_counter()
    out = jax.block_until_ready(fwd(scene, camera))
    compile_fwd = time.perf_counter() - t0
    dt_f = statistics.median(call_times(fwd, scene, camera, n=args.iters))
    log(f"forward: compile+first {compile_fwd:.1f}s, {dt_f * 1e3:.3f} "
        f"ms/frame = {num_rays / dt_f:.4e} rays/s")

    t0 = time.perf_counter()
    jax.block_until_ready(fwd_bwd(scene, camera))
    compile_fb = time.perf_counter() - t0
    dt_fb = statistics.median(call_times(fwd_bwd, scene, camera,
                                         n=args.iters))
    log(f"fwd+bwd: compile+first {compile_fb:.1f}s, {dt_fb * 1e3:.3f} "
        f"ms/step = {num_rays / dt_fb:.4e} rays/s")

    scfg = dataclasses.replace(config, with_stats=True)
    _, stats = jax.jit(lambda s, c: intersect_binned(
        c.pos, None, s.objects[0].tris, c.projection(), scfg,
        c.res_h, c.res_w))(scene, camera)
    stats = {k: int(v) for k, v in stats.items()}
    log(f"bin stats: {stats}")

    agree_full = max_dt = None
    if args.agree_full:
        t_ref, tri_ref = oracle_hits(scene, camera, config)
        tri = np.asarray(out.hit_tri).reshape(-1)
        t = np.asarray(out.hit_t).reshape(-1)
        agree_full = float(np.mean(tri == tri_ref))
        m = (tri == tri_ref) & (tri >= 0)
        max_dt = float(np.max(np.abs(t[m] - t_ref[m]))) if m.any() else 0.0
        log(f"agree_full vs oracle: {agree_full:.6f} (max|dt| {max_dt:.3e})")

    rays_s = num_rays / dt_fb
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_line}
    details = {
        "scene": args.scene, "num_tris": scene.objects[0].tris.num_triangles,
        "resolution": [args.width, args.height], "device": device,
        "compile_fwd_s": compile_fwd, "compile_fwd_bwd_s": compile_fb,
        "fwd_ms": dt_f * 1e3, "fwd_rays_per_sec": num_rays / dt_f,
        "fwd_bwd_ms": dt_fb * 1e3, "fwd_bwd_rays_per_sec": rays_s,
        "agree_full_vs_oracle": agree_full, "max_abs_dt": max_dt,
        "bin_stats": stats,
        "reference_rays_per_sec_fwd_only": REF_RAYS_PER_SEC,
    }
    with open("BENCH_DETAILS.json", "w") as f:
        json.dump(details, f, indent=2)
    if agree_full is not None and agree_full < 0.9999:
        sys.exit(f"agree_full {agree_full:.6f} < 0.9999: the bin path's "
                 "winners disagree with the oracle; no result")

    print(json.dumps({
        "metric": f"rays/sec fwd+bwd ({args.scene} "
                  f"{details['num_tris']} tris @ {args.width}x{args.height})",
        "value": rays_s,
        "unit": "rays/s",
        "vs_baseline": rays_s / REF_RAYS_PER_SEC,
        "device": device,
    }))


if __name__ == "__main__":
    main()
