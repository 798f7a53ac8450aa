"""Screen-space tile binning — the cull for primary rays.

The reference traverses a KD tree per ray (``TEST_Dungeonrun/Trixel.cu:
41-172``): work scales with per-ray divergent node visits. For *primary*
rays (all through one origin — exactly the reference's rendering model,
1 ray/pixel, no bounces) there is an exact and much cheaper cull: **project
every triangle once and bin it to the image tiles its screen bbox
overlaps** (elementwise math + one sort), then intersect each tile only
against its own bin, front-to-back. A pixel's ray can only hit a triangle
whose projection covers that pixel, so binning by projected bbox (+guard)
is conservative: it never drops a hittable pair.

Per object and frame (all traced, so animation/camera updates are free):

1.  project the 3 vertices through `Projection` (models/camera.py) into
    subpixel coords; a = forward depth along the view axis;
2.  pixel bbox (+0.5 px guard) -> tile range; triangles crossing the
    camera plane (some vertex behind) bin to every tile (conservative,
    none in practice when the camera is outside the mesh); fully-behind
    or offscreen triangles drop;
3.  expand triangle -> (tile, tri) entries without scatters of data:
    exclusive cumsum of per-tri tile counts + an indicator cumsum recovers,
    for each flat entry index, which triangle it belongs to (static E_cap
    bound, overflow counted and reported);
4.  one 32-bit key sort orders entries by (tile, quantized min-depth):
    tile segments come out contiguous AND front-to-back — the kernel's
    early-exit order;
5.  entry geometry is gathered once into a (12, E) table of Möller–Trumbore
    constants (ops/pallas/bin_intersect.py), whose depth row is the
    per-tile suffix minimum of the entries' min-vertex depths: a lower
    bound on every later hit in the tile (t_hit >= (p-origin)·n for unit
    rays), which is the kernel's exit certificate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

BIG = 3.0e38   # python float: a concrete jnp constant at module
               # level breaks tracing inside shard_map bodies


@pytree_dataclass
class BinnedScene:
    """Per-frame, per-object binning output (traced values)."""

    geom: jax.Array      # (12, Epad) f32 MT-constant table: rows
                         #   A(3) | B(3) | C(3) | TD | depth | tri-id
                         #   (layout: ops/pallas/bin_intersect.py)
    entry_tri: jax.Array  # (Epad,) i32 triangle id per entry (-1 padding)
    starts: jax.Array    # (nT + 1,) i32 entry range per tile
    # diagnostics (per frame)
    num_entries: jax.Array      # scalar i32 — total live entries
    overflow_entries: jax.Array  # scalar i32 — entries dropped past E_cap
    cross_tris: jax.Array       # scalar i32 — camera-plane-crossing tris


@functools.partial(
    jax.jit, static_argnames=("res_h", "res_w", "th", "tw", "e_cap",
                              "chunk", "eps", "backface_cull", "_stage"))
def bin_triangles(proj, origin: jax.Array,
                  p1: jax.Array, e1: jax.Array, e2: jax.Array,
                  res_h: int, res_w: int, th: int, tw: int,
                  e_cap: int, chunk: int = 512, eps: float = 1e-16,
                  backface_cull: bool = False,
                  _stage: str | None = None) -> BinnedScene:
    """Bin triangles (object frame) to (th x tw) pixel tiles.

    proj: Projection already transformed into the object frame; origin:
    (3,) object-frame ray origin (folded into the per-entry MT constant
    table). Returns entries sorted by (tile, quantized depth) with their
    MT constants gathered in entry order; the table is padded by ``chunk``
    dead columns so a kernel's chunk reads never leave it. e_cap bounds
    total entries (static shape).

    _stage: return intermediates early ("sort": sorted keys and triangle
    ids, "starts": tile starts and triangle ids), for tests of the stages.
    """
    f32 = jnp.float32

    def _cols(a):
        # (T, 3) arrays OR pre-flattened (ax, ay, az) component tuples —
        # callers on the hot path pass the Triangles flat fields directly
        if isinstance(a, (tuple, list)):
            return a
        return a[:, 0], a[:, 1], a[:, 2]

    t_n = _cols(p1)[0].shape[0]
    e_cap = -(-e_cap // chunk) * chunk                      # chunk-align
    n_tx = -(-res_w // tw)
    n_ty = -(-res_h // th)
    n_tiles = n_tx * n_ty

    # Project all 3 verts componentized: the basis contraction is written
    # as 9 scalar-broadcast FMAs per vertex over flat (T,) arrays, which
    # XLA fuses into one elementwise pass.
    p1x, p1y, p1z = _cols(p1)                               # (T,) each
    e1x, e1y, e1z = _cols(e1)
    e2x, e2y, e2z = _cols(e2)
    q0x, q0y, q0z = (p1x - proj.origin[0], p1y - proj.origin[1],
                     p1z - proj.origin[2])

    def _dotb(vx, vy, vz, b):
        return vx * b[0] + vy * b[1] + vz * b[2]

    a0 = _dotb(q0x, q0y, q0z, proj.n)                       # (T,) each
    b0 = _dotb(q0x, q0y, q0z, proj.u)
    c0 = _dotb(q0x, q0y, q0z, proj.v)
    a1 = a0 + _dotb(e1x, e1y, e1z, proj.n)
    b1 = b0 + _dotb(e1x, e1y, e1z, proj.u)
    c1 = c0 + _dotb(e1x, e1y, e1z, proj.v)
    a2 = a0 + _dotb(e2x, e2y, e2z, proj.n)
    b2 = b0 + _dotb(e2x, e2y, e2z, proj.u)
    c2 = c0 + _dotb(e2x, e2y, e2z, proj.v)

    f0, f1, f2 = a0 > 0.0, a1 > 0.0, a2 > 0.0
    all_front = f0 & f1 & f2
    any_front = f0 | f1 | f2
    cross = any_front & ~all_front                          # (T,)

    if backface_cull:
        # Primary rays share one origin, so "facing away" is a single
        # per-triangle plane test: (e1 x e2) . (p1 - o) > 0. Such a
        # triangle can only be hit on its BACK side, and for a closed,
        # consistently-wound surface viewed from outside that hit is
        # always occluded by a nearer front face (the ray must first
        # enter through one) — culling its entries is exact. The
        # reference's MT is two-sided (|det| acceptance,
        # Trixel.cu:101-126), so this is OFF by default and only enabled
        # for scenes where the occlusion argument holds; bench.py
        # validates full-image agreement against the two-sided oracle
        # whenever it is on. E at dragon scale drops ~2x (back half of
        # the surface), which every per-entry prepass stage inherits.
        nx = e1y * e2z - e1z * e2y
        ny = e1z * e2x - e1x * e2z
        nz = e1x * e2y - e1y * e2x
        away = (nx * (p1x - origin[0]) + ny * (p1y - origin[1])
                + nz * (p1z - origin[2])) > 0.0
        cross = cross & ~away
        any_front = any_front & ~away

    def _px(b, a):
        return proj.adjust_x + proj.sx * (b / jnp.maximum(a, 1e-20))

    def _py(c, a):
        return proj.adjust_y + proj.sy * (c / jnp.maximum(a, 1e-20))

    px0, px1_, px2 = _px(b0, a0), _px(b1, a1), _px(b2, a2)
    py0, py1_, py2 = _py(c0, a0), _py(c1, a1), _py(c2, a2)

    guard = 0.5
    x0 = jnp.minimum(jnp.minimum(px0, px1_), px2) - guard
    x1 = jnp.maximum(jnp.maximum(px0, px1_), px2) + guard
    y0 = jnp.minimum(jnp.minimum(py0, py1_), py2) - guard
    y1 = jnp.maximum(jnp.maximum(py0, py1_), py2) + guard
    # camera-plane crossers: conservative full-screen bbox
    x0 = jnp.where(cross, 0.0, x0)
    y0 = jnp.where(cross, 0.0, y0)
    x1 = jnp.where(cross, f32(res_w - 1), x1)
    y1 = jnp.where(cross, f32(res_h - 1), y1)

    ix0 = jnp.clip(jnp.ceil(x0), 0, res_w - 1).astype(jnp.int32)
    ix1 = jnp.floor(jnp.clip(x1, 0, res_w - 1)).astype(jnp.int32)
    iy0 = jnp.clip(jnp.ceil(y0), 0, res_h - 1).astype(jnp.int32)
    iy1 = jnp.floor(jnp.clip(y1, 0, res_h - 1)).astype(jnp.int32)
    onscreen = (any_front & (x1 >= 0) & (x0 <= res_w - 1)
                & (y1 >= 0) & (y0 <= res_h - 1)
                & (ix1 >= ix0) & (iy1 >= iy0))

    tx0 = ix0 // tw
    ty0 = iy0 // th
    ntx = jnp.where(onscreen, ix1 // tw - tx0 + 1, 0)       # (T,)
    nty = jnp.where(onscreen, iy1 // th - ty0 + 1, 0)
    ntiles_tri = ntx * nty

    # ---- expansion: entry j -> (tri, si) ----
    # tri_j = #{t : cum[t] <= j} (searchsorted-right over the inclusive
    # cumsum), computed as a boundary-indicator scatter-add + cumsum: the
    # same monotone step function without a per-entry binary search.
    cum = jnp.cumsum(ntiles_tri)                            # inclusive
    e_tot = cum[-1]
    j = jnp.arange(e_cap, dtype=jnp.int32)
    ind = jnp.zeros((e_cap,), jnp.int32).at[cum].add(1, mode="drop")
    tri_j = jnp.cumsum(ind)
    valid = j < jnp.minimum(e_tot, e_cap)
    tri_j = jnp.minimum(tri_j, t_n - 1)

    # ---- (tile, depth) key sort ----
    # one i32 key: tile id in the high bits, quantized depth in however
    # many bits remain (depth only orders the scan front-to-back — the
    # exact per-entry depth rides the geometry table as the certificate)
    dbits = 31 - n_tiles.bit_length()
    if dbits < 6:
        raise ValueError(f"{n_tiles} tiles leaves only {dbits} depth bits; "
                         "use larger tiles")
    dmax = (1 << dbits) - 1
    depth = jnp.minimum(
        jnp.minimum(jnp.where(f0, a0, BIG), jnp.where(f1, a1, BIG)),
        jnp.where(f2, a2, BIG))                             # (T,)
    depth = jnp.maximum(depth, 0.0)
    # camera-plane crossers: a hit can be NEARER than the min front-vertex
    # depth (the hit point's n-component is unconstrained below it), so
    # their exit certificate must be 0 or the kernel could stop before
    # the entry holding the true nearest hit (camera-inside scenes). They
    # already get full-screen bboxes above.
    depth = jnp.where(cross, 0.0, depth)
    d_lo = jnp.min(jnp.where(onscreen, depth, BIG))
    d_hi = jnp.max(jnp.where(onscreen & jnp.isfinite(depth), depth, 0.0))
    scale = f32(dmax) / jnp.maximum(d_hi - d_lo, 1e-20)
    # clamp in INT space: a large dmax (e.g. 2^25-1) is not representable
    # in f32, so a float clip bound rounds UP to 2^dbits and the quantized
    # depth overflows into the tile bits (measured: entries landing in the
    # wrong tile segment)
    dq = jnp.clip(
        jnp.maximum((depth - d_lo) * scale, 0.0).astype(jnp.int32),
        0, dmax)

    # per-entry values via ONE packed (T, 6) row gather
    itab = jnp.stack([cum, ntiles_tri, ntx, tx0, ty0, dq], axis=1)
    ient = jnp.take(itab, tri_j, axis=0)                    # (E, 6)
    si = j - ient[:, 0] + ient[:, 1]
    ntx_j = jnp.maximum(ient[:, 2], 1)
    dx = si % ntx_j
    dy = si // ntx_j
    tile_j = (ient[:, 4] + dy) * n_tx + ient[:, 3] + dx     # (E,)

    key = jnp.where(valid,
                    (tile_j << dbits) | ient[:, 5],
                    jnp.int32(2**31 - 1))
    key, tri_sorted = jax.lax.sort((key, tri_j), num_keys=1)
    tri_sorted = jnp.where(key == 2**31 - 1, -1, tri_sorted)
    if _stage == "sort":
        return key, tri_sorted

    # ---- per-tile segment starts: lower_bound(sorted keys, t << dbits),
    # as one fused count-reduction starts[t] = #{j : tile(key_j) < t}.
    # Invalid entries carry key 2^31-1 => tile id > every real tile,
    # counted past the end.
    tile_of = (key >> dbits)                                # (E,) sorted
    q = jnp.arange(n_tiles, dtype=jnp.int32)                # (nT,)
    lo = jnp.sum((tile_of[None, :] < q[:, None]).astype(jnp.int32),
                 axis=1)                                    # (nT,)
    n_valid = jnp.minimum(e_tot, e_cap).astype(jnp.int32)
    starts = jnp.concatenate([jnp.minimum(lo, n_valid), n_valid[None]])
    if _stage == "starts":
        return starts, tri_sorted

    # ---- per-entry Möller–Trumbore constant table, chunk-blocked ----
    # Primary rays all share the object-frame origin, so the MT solve
    # collapses to three dot products per (entry, ray): precompute the
    # epsilon-folded constants per TRIANGLE (the reference's own
    # per-camera cache, Trixel.cu:29-36 / init_cam_tri_mem_cuda), then
    # gather rows per entry into the (12, E) layout the kernel reads
    # (ops/pallas/bin_intersect.py docstring).
    ox, oy, oz = origin[0], origin[1], origin[2]
    tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
    mdx = e2y * e1z - e2z * e1y                             # e2 x e1
    mdy = e2z * e1x - e2x * e1z
    mdz = e2x * e1y - e2y * e1x
    mux = e2y * tvz - e2z * tvy                             # e2 x tv
    muy = e2z * tvx - e2x * tvz
    muz = e2x * tvy - e2y * tvx
    mvx = tvy * e1z - tvz * e1y                             # tv x e1
    mvy = tvz * e1x - tvx * e1z
    mvz = tvx * e1y - tvy * e1x
    td = e2x * mvx + e2y * mvy + e2z * mvz
    k1 = f32(1.0 - eps)
    # row 11: the triangle id as f32 (exact below 2^24), so the kernel
    # returns the winner's id without a per-ray decode gather. ONE
    # (T, 12) -> (E, 12) row gather, then transposed to (12, Epad).
    ftab = jnp.stack(
        [k1 * mdx, k1 * mdy, k1 * mdz,
         mux - eps * mdx, muy - eps * mdy, muz - eps * mdz,
         mvx - eps * mdx, mvy - eps * mdy, mvz - eps * mdz,
         k1 * td, depth,
         jnp.arange(t_n, dtype=jnp.float32)], axis=1)       # (T, 12)

    epad = e_cap + chunk                  # kernel block reads never OOB
    safe = jnp.maximum(tri_sorted, 0)
    live = (tri_sorted >= 0)[:, None]
    rows = jnp.take(ftab, safe, axis=0)                     # one gather
    dead_row = jnp.concatenate([jnp.zeros((10,), jnp.float32),
                                jnp.full((1,), BIG, jnp.float32),
                                jnp.full((1,), -1.0, jnp.float32)])
    rows = jnp.where(live, rows, dead_row)                  # det=0 rejects
    # exit certificate: suffix minimum of the depth within each tile, so
    # the value at any entry bounds every later entry of its tile
    rows = rows.at[:, 10].set(_segment_suffix_min(tile_of, rows[:, 10]))
    rows = jnp.concatenate(
        [rows, jnp.broadcast_to(dead_row, (chunk, 12))], axis=0)
    geom = rows.T                                           # (12, Epad)
    entry_tri = jnp.concatenate(
        [tri_sorted, jnp.full((chunk,), -1, jnp.int32)])

    return BinnedScene(
        geom=geom, entry_tri=entry_tri, starts=starts,
        num_entries=jnp.minimum(e_tot, e_cap).astype(jnp.int32),
        overflow_entries=jnp.maximum(e_tot - e_cap, 0).astype(jnp.int32),
        cross_tris=jnp.sum(cross.astype(jnp.int32)),
    )


def _segment_suffix_min(seg: jax.Array, val: jax.Array) -> jax.Array:
    """out[j] = min(val[k] for k >= j with seg[k] == seg[j]); ``seg`` must
    be sorted, so every segment is one contiguous run."""
    def op(later, cur):
        s_l, v_l = later
        s_c, v_c = cur
        return s_c, jnp.where(s_l == s_c, jnp.minimum(v_l, v_c), v_c)

    _, out = jax.lax.associative_scan(op, (seg, val), reverse=True)
    return out
