"""Nearest hit per primary ray over screen-space tile bins — a Pallas kernel
for NVIDIA GPUs through the Triton route.

Input contract (accel/binning.py): a (12, Epad) float32 entry table sorted
by (tile, depth), rows

    0-2   A  = (1 - eps)·(e2 x e1)          det  = d·A
    3-5   B  = e2 x tv - eps·(e2 x e1)      u'   = d·B
    6-8   C  = tv x e1 - eps·(e2 x e1)      v'   = d·C
    9     TD = (1 - eps)·e2·(tv x e1)       t    = TD / det
    10    depth certificate: a lower bound on the hit distance of this entry
          and of every later entry of the same tile (suffix minimum)
    11    triangle id as float32 (exact below 2^24)

with ``tv = origin - p1``, plus ``starts`` (nT + 1,) int32, tile t owning
entries ``[starts[t], starts[t+1])``, and a (4, nT·P) ray table: unit
direction rows 0-2 and row 3 the ray's exit distance from the object's
bounding box (0 for a ray that misses it), in row-major tile order.

The primary rays share one origin, so Möller–Trumbore reduces to the three
dot products above per (ray, entry) — float32 FMA work with K = 3, which
stays on the CUDA cores (no tensor-core form pays at that depth). The
epsilon-folded acceptance test is the reference's (Trixel.cu:106,127):
|det| >= eps, u, v >= eps, u + v <= 1 + eps, t >= eps, multiplied through
by det so no division happens before acceptance.

Grid: one program per (tile, ray slice). Each program keeps its slice's
running best t and id in registers and walks its tile's own segment in
chunks of ``chunk`` entries, front to back. It stops as soon as the next
entry's certificate passes the slice's farthest still-improvable ray
(``max(min(best_t, exit))``): every later entry of the tile can then only
produce a hit beyond what each ray already has. Exact-t ties go to the
smallest triangle id wherever they are found — the brute-force oracle's
rule — so the winner does not depend on the tiling, the entry order or
the launch shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...utils.dtypes import MT_EPSILON

_MISS_T = 3.0e38
# Launch shape: the best point of a sweep of chunk x programs per tile x
# warps x stages on an H100 at dragon-class size (PERF.md).
N_SUB = 16
_NUM_WARPS = 2
_NUM_STAGES = 2


def interpret_default() -> bool:
    """Pallas kernels run in the interpreter on the CPU backend only."""
    return jax.default_backend() == "cpu"


def _kernel(starts_ref, rays_ref, geom_ref, t_ref, tri_ref, *,
            p: int, s: int, chunk: int, eps: float, draw_distance: float):
    tile = pl.program_id(0)
    r0 = tile * p + pl.program_id(1) * s
    rs = pl.ds(r0, s)
    dx = plgpu.load(rays_ref.at[0, rs])[:, None]               # (s, 1)
    dy = plgpu.load(rays_ref.at[1, rs])[:, None]
    dz = plgpu.load(rays_ref.at[2, rs])[:, None]
    bound = plgpu.load(rays_ref.at[3, rs])                     # (s,)
    start = starts_ref[tile]
    end = starts_ref[tile + 1]
    lane = jnp.arange(chunk, dtype=jnp.int32)
    eps2_det = ((1.0 - eps) * eps) ** 2

    def cond(carry):
        off, best_t, _ = carry
        wb = jnp.max(jnp.minimum(best_t, bound))
        return (off < end) & (geom_ref[10, off] <= wb)

    def body(carry):
        off, best_t, best_tri = carry
        cs = pl.ds(off, chunk)
        g = [plgpu.load(geom_ref.at[r, cs])[None, :] for r in range(10)]
        ids = plgpu.load(geom_ref.at[11, cs])[None, :]         # (1, chunk)
        live = (off + lane < end)[None, :]
        det = dx * g[0] + dy * g[1] + dz * g[2]                # (s, chunk)
        up = dx * g[3] + dy * g[4] + dz * g[5]
        vp = dx * g[6] + dy * g[7] + dz * g[8]
        td = g[9]
        dd2 = det * det
        q = jnp.minimum(up * det, vp * det)
        q = jnp.minimum(q, (det - up - vp) * det)
        q = jnp.minimum(q, td * det - eps * dd2)
        ok = (q >= 0.0) & (dd2 >= eps2_det) & live
        tt = jnp.where(ok, td / jnp.where(det == 0.0, 1.0, det), _MISS_T)
        tmin = jnp.min(tt, axis=1)                             # (s,)
        tri = jnp.min(jnp.where(tt == tmin[:, None], ids, _MISS_T),
                      axis=1).astype(jnp.int32)
        better = (tmin < best_t) | ((tmin == best_t) & (tri < best_tri))
        return (off + chunk, jnp.where(better, tmin, best_t),
                jnp.where(better, tri, best_tri))

    init = (start, jnp.full((s,), draw_distance, jnp.float32),
            jnp.full((s,), -1, jnp.int32))
    _, best_t, best_tri = jax.lax.while_loop(cond, body, init)
    plgpu.store(t_ref, best_t)
    plgpu.store(tri_ref, best_tri)


@functools.partial(
    jax.jit,
    static_argnames=("p", "n_sub", "chunk", "eps", "draw_distance",
                     "interpret"))
def bin_intersect(starts: jax.Array, rays: jax.Array, geom: jax.Array, *,
                  p: int, n_sub: int = N_SUB, chunk: int = 16,
                  eps: float = MT_EPSILON, draw_distance: float = 400.0,
                  interpret: bool = False):
    """(t (nT·P,) float32, tri (nT·P,) int32, -1 on miss) per ray.

    ``geom`` must hold at least ``chunk`` columns past the last live entry
    (accel/binning.py pads it), so chunk reads never leave the table;
    columns past a tile's end are masked. ``p / n_sub`` rays per program
    and ``chunk`` must be powers of two.
    """
    s = p // n_sub
    if s * n_sub != p or s & (s - 1) or chunk & (chunk - 1):
        raise ValueError(f"p={p}, n_sub={n_sub}, chunk={chunk}: need "
                         "p/n_sub and chunk to be powers of two")
    n = rays.shape[1]
    n_tiles = n // p
    if geom.shape[0] != 12 or starts.shape[0] != n_tiles + 1:
        raise ValueError(f"geom {geom.shape} / starts {starts.shape} do "
                         f"not match {n_tiles} tiles")
    kernel = functools.partial(_kernel, p=p, s=s, chunk=chunk, eps=eps,
                               draw_distance=draw_distance)
    out_spec = pl.BlockSpec((s,), lambda t, j: (t * n_sub + j,))
    return pl.pallas_call(
        kernel,
        grid=(n_tiles, n_sub),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32),
                   jax.ShapeDtypeStruct((n,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="bin_intersect",
    )(starts, rays, geom)
