"""The benchmark scenes: seeded procedural meshes at the reference's
headline scale, with their camera and main-path render configuration.

The reference's headline mesh (Stanford dragon, ~800k triangles, 960x540 —
README.md:19) is not in its repository, so the scenes are deterministic
meshes of the same primitive count (utils/procgen.py):

- ``dragon-class``: a roughened closed sphere, viewed head-on;
- ``clustered``: a coarse sphere studded with finely tessellated blobs
  (very uneven triangle density), viewed obliquely.

Both are closed and consistently wound, so backface culling before binning
(accel/binning.py) keeps every first hit but a few per frame: the
acceptance epsilon leaves hairline gaps along triangle edges, and a ray
through one reaches a back face inside the surface, which the two-sided
oracle reports and the cull drops. The entry-table capacity is sized to
the culled entry count.
"""

from __future__ import annotations

import numpy as np

SCENES = ("dragon-class", "clustered")


def bench_scene(name: str = "dragon-class", num_tris: int = 800_000,
                width: int = 960, height: int = 540, **config):
    """(scene, camera, RenderConfig) for a benchmark scene; ``config``
    overrides RenderConfig fields."""
    from ..models.camera import Camera
    from ..models.scene import Scene, SceneObject, Triangles
    from .config import RenderConfig
    from .procgen import clustered_mesh, dragon_class_mesh

    if name == "dragon-class":
        tv = dragon_class_mesh(num_tris)
        pos = np.array([0.0, 0.0, -3.0], np.float32)
        e_factor = 0.55
    elif name == "clustered":
        tv = clustered_mesh(num_tris)
        pos = np.array([0.6, 0.25, -2.6], np.float32)   # oblique view
        e_factor = 0.8
    else:
        raise ValueError(f"unknown scene {name!r}; one of {SCENES}")
    scene = Scene.create([SceneObject.create(Triangles.from_vertices(tv))])
    camera = Camera.create(width, height, pos=pos, look_at=[0.0, 0.0, 0.0],
                           up=[0.0, 1.0, 0.0], film_h=0.024, focal=0.055)
    cfg = dict(method="bin", backface_cull=True, bin_e_factor=e_factor)
    cfg.update(config)
    return scene, camera, RenderConfig(**cfg)


def oracle_hits(scene, camera, config, slab: int = 65536):
    """Full-image nearest hits from the brute-force ``fixed`` oracle
    (matmul-form Möller–Trumbore at Precision.HIGHEST, ops/intersect.py —
    the role of the reference's ground-truth kernel, Trixel.cu:173-209),
    in ray slabs to bound the (rays x triangle-chunk) intermediates.
    Returns numpy (t, tri)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from ..models.renderer import trace_rays

    ref = dataclasses.replace(config, method="fixed", chunk=2048,
                              with_stats=False)
    rmd = camera.ray_directions()
    r = rmd.shape[0]
    rmd = jnp.concatenate(
        [rmd, jnp.broadcast_to(rmd[:1], ((-r) % slab, 3))])
    fn = jax.jit(lambda sc, o, d: trace_rays(sc, o, d, ref))
    ts, tris = [], []
    for s in range(rmd.shape[0] // slab):
        hit = fn(scene, camera.pos, rmd[s * slab:(s + 1) * slab])
        ts.append(np.asarray(hit.t))
        tris.append(np.asarray(hit.tri))
    return np.concatenate(ts)[:r], np.concatenate(tris)[:r]
