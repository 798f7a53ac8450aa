"""Procedural benchmark meshes.

The reference's headline benchmark mesh (Stanford dragon, ~800k triangles —
README.md:19) ships stripped from the repo (`.MISSING_LARGE_BLOBS`), so the
benchmark harness synthesizes deterministic meshes of exactly the same
primitive count: a UV sphere with 2*lat*lon triangles and optional radial
displacement to roughen the surface (dragon-class triangle density and
depth complexity without the asset).
"""

from __future__ import annotations

import numpy as np


def uv_sphere_grid(lat: int, lon: int, radius: float = 1.0,
                   roughness: float = 0.0, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Indexed form of `uv_sphere`: ((lat+1)*(lon+1), 3) float32 vertices
    and (lat*lon, 4) int quads (a, b, c, d) over the lat x lon grid.

    roughness > 0 displaces vertices radially with deterministic noise.
    """
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, lat + 1)           # (lat+1,)
    phi = np.linspace(0.0, 2 * np.pi, lon + 1)         # (lon+1,)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    if roughness:
        noise = rng.standard_normal(t.shape)
        # weld the displacement so the surface stays watertight: the
        # phi = 0 and phi = 2*pi grid columns are duplicate positions and
        # each pole row is one point; independent noise would tear the
        # seam open and expose interior back faces through the cracks
        noise[:, -1] = noise[:, 0]
        noise[0, :] = noise[0, 0]
        noise[-1, :] = noise[-1, 0]
        r = radius * (1.0 + roughness * noise)
    else:
        r = radius
    x = r * np.sin(t) * np.cos(p)
    y = r * np.cos(t)
    z = r * np.sin(t) * np.sin(p)
    v = np.stack([x, y, z], axis=-1).astype(np.float32).reshape(-1, 3)

    ids = np.arange((lat + 1) * (lon + 1)).reshape(lat + 1, lon + 1)
    quads = np.stack([ids[:-1, :-1], ids[:-1, 1:], ids[1:, 1:],
                      ids[1:, :-1]], axis=-1).reshape(-1, 4)
    return v, quads


def uv_sphere(lat: int, lon: int, radius: float = 1.0,
              roughness: float = 0.0, seed: int = 0) -> np.ndarray:
    """(T, 3, 3) float32 triangle soup with T = 2*lat*lon.

    lat x lon quad grid over the sphere, each quad (a, b, c, d) split into
    (a, b, c) + (a, c, d) (the same quad split the PLY loader performs,
    read_ply.cpp:70-125).
    """
    v, quads = uv_sphere_grid(lat, lon, radius, roughness, seed)
    tris = np.stack([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=1)
    return v[tris.reshape(-1, 3)]


def dragon_class_mesh(num_tris: int = 800_000, seed: int = 0) -> np.ndarray:
    """A deterministic mesh with ~num_tris triangles (within one row)."""
    lat = int(np.sqrt(num_tris / 4))
    lon = int(np.ceil(num_tris / (2 * lat)))
    return uv_sphere(lat, lon, roughness=0.03, seed=seed)


def clustered_mesh(num_tris: int = 800_000, seed: int = 0,
                   blobs: int = 24) -> np.ndarray:
    """Adversarially *uneven* triangle density: a coarse base sphere
    (~20% of triangles) studded with `blobs` tiny, very finely tessellated
    spheres (~80%). Tiles seeing a blob face thousands of primitives in a
    handful of clusters while base-sphere tiles see few — the regime where
    a fixed per-tile candidate budget (max_candidates) overflows and where
    uniform meshes (uv_sphere, with its uniform depth complexity) flatter
    the cull."""
    rng = np.random.default_rng(seed)
    base_n = max(num_tris // 5, 1000)
    lat = max(int(np.sqrt(base_n / 4)), 4)
    lon = max(int(np.ceil(base_n / (2 * lat))), 4)
    parts = [uv_sphere(lat, lon, radius=1.0, roughness=0.02, seed=seed)]

    per_blob = (num_tris - parts[0].shape[0]) // blobs
    blat = max(int(np.sqrt(per_blob / 4)), 4)
    blon = max(int(np.ceil(per_blob / (2 * blat))), 4)
    for b in range(blobs):
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        r_blob = 0.05 + 0.08 * rng.random()
        blob = uv_sphere(blat, blon, radius=r_blob, roughness=0.05,
                         seed=seed + 1 + b)
        parts.append(blob + (u * (1.0 + 0.5 * r_blob)).astype(np.float32))
    return np.concatenate(parts, axis=0)
