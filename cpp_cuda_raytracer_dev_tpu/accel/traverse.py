"""Accelerated ray traversal: screen-space bins, cluster culling, KD walk.

1. `intersect_binned` — the main path (method="bin"): per-frame
   screen-space tile binning (accel/binning.py) feeding the per-tile
   nearest-hit kernel (ops/pallas/bin_intersect.py).

Two consumers of the KD build (accel/kd_build.py):

2. `ClusterAccel` / `intersect_clustered` (method="grid"). The
   reference walks a per-ray divergent stack over a leaf-size-1 KD tree
   (``TEST_Dungeonrun/Trixel.cu:41-172``); a vector machine wants dense
   batches instead, so we stop the same median-split build at wide leaves
   ("clusters" of ~128 triangles, spatially coherent by construction),
   then per *ray tile* (a rectangle of coherent primary rays):

     a. frustum-cull all cluster AABBs against the tile's 4-plane cone
        (exact frustum, conservative AABB): tiles x clusters plane tests,
        a few MFLOPs — this replaces per-ray tree traversal entirely;
     b. keep the nearest `max_candidates` visible clusters (static shape);
     c. gather their padded triangle blocks and run the matmul-form
        Möller–Trumbore (ops/intersect.py) for the whole tile at once,
        with a masked min-reduction for the nearest hit.

   The role the per-ray stack plays for SIMT divergence is played here by
   tile coherence: primary rays in a tile see nearly the same clusters.

3. `kd_intersect` — a faithful vectorized port of the reference's traversal
   *semantics* (slab test + s1/s2 near-far child ordering + per-ray stack,
   Trixel.cu:70-169) over the flattened tables, run lockstep over a ray
   batch inside one `lax.while_loop`. It exists to validate tree structure
   and ordering rules against the brute-force oracle (and works for any
   leaf size); it is not the perf path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import vecmath
from ..ops.intersect import Hit
from ..utils.config import RenderConfig
from ..utils.dtypes import MT_EPSILON, SLAB_EPSILON
from ..utils.pytree import pytree_dataclass, static_field
from .kd_build import KDTree, build_kd

_HP = jax.lax.Precision.HIGHEST


@pytree_dataclass
class ClusterAccel:
    """Wide-leaf KD clusters with padded, contiguous triangle slots.

    Slot arrays have shape (C*L, ...) where C = #clusters, L = slot count
    per cluster; padding slots have slot_tri = -1 and degenerate geometry
    (det = 0 -> never hit). This is the dense flattening of the
    reference's voxel tables (Camera.h:69-84).
    """

    bounds_min: jax.Array   # (C, 3)
    bounds_max: jax.Array   # (C, 3)
    centers: jax.Array      # (C, 3)
    # One packed geometry block per cluster (columns: p1.xyz | e1.xyz |
    # e2.xyz) and the slot->tri map as (C, L); static per scene.
    geom_t: jax.Array       # (C, L, 9) float32
    slot_mat: jax.Array     # (C, L) int32, original tri index, -1 = padding
    leaf_size: int = static_field()

    @property
    def num_clusters(self) -> int:
        return self.bounds_min.shape[0]

    # flat per-slot views (device-side reshapes — free under jit)
    @property
    def p1(self) -> jax.Array:
        return self.geom_t.reshape(-1, 9)[:, 0:3]

    @property
    def e1(self) -> jax.Array:
        return self.geom_t.reshape(-1, 9)[:, 3:6]

    @property
    def e2(self) -> jax.Array:
        return self.geom_t.reshape(-1, 9)[:, 6:9]

    @property
    def slot_tri(self) -> jax.Array:
        return self.slot_mat.reshape(-1)

    @classmethod
    def build(cls, tris, leaf_size: int = 128,
              cache: bool = True) -> "ClusterAccel":
        """Host-side build (numpy): KD build -> leaf extraction -> padding.

        With ``cache=True`` the KD tree is loaded from / saved to the disk
        cache keyed by mesh hash + leaf size (utils/cache.py) — the
        checkpoint/resume analogue of SURVEY.md §5: the reference re-sorts
        and rebuilds its tree on every launch (WinMain.cpp:122-151)."""
        p1 = np.asarray(tris.p1)
        e1 = np.asarray(tris.e1)
        e2 = np.asarray(tris.e2)
        v = np.stack([p1, p1 + e1, p1 + e2], axis=1)
        amin, amax = v.min(axis=1), v.max(axis=1)
        if cache:
            from ..utils.cache import build_kd_cached
            tree = build_kd_cached(amin, amax, min_node_size=leaf_size)
        else:
            from .native import build_kd_fast
            tree = build_kd_fast(amin, amax, min_node_size=leaf_size)
        leaf_ids = np.nonzero(tree.is_leaf)[0]
        ln = leaf_size
        # vectorized leaf extraction: one gather instead of a per-leaf loop
        starts = tree.leaf_start[leaf_ids].astype(np.int64)    # (C,)
        counts = tree.leaf_count[leaf_ids].astype(np.int64)
        lane = np.arange(ln, dtype=np.int64)[None, :]          # (1, L)
        valid = lane < counts[:, None]                         # (C, L)
        pos = np.minimum(starts[:, None] + lane, p1.shape[0] - 1)
        ids = tree.perm[pos]                                   # (C, L)
        slot_tri = np.where(valid, ids, -1).astype(np.int32)
        v3 = valid[:, :, None]
        sp1 = np.where(v3, p1[ids], 0.0).astype(np.float32)
        se1 = np.where(v3, e1[ids], 0.0).astype(np.float32)
        se2 = np.where(v3, e2[ids], 0.0).astype(np.float32)
        bmin = tree.bounds_min[leaf_ids]
        bmax = tree.bounds_max[leaf_ids]
        geom_t = np.concatenate([sp1, se1, se2], axis=2)  # (C, L, 9)
        return cls(
            bounds_min=jnp.asarray(bmin), bounds_max=jnp.asarray(bmax),
            centers=jnp.asarray((bmin + bmax) / 2.0),
            geom_t=jnp.asarray(geom_t),
            slot_mat=jnp.asarray(slot_tri),
            leaf_size=leaf_size,
        )


def _tile_rays(d: jax.Array, res_h: int, res_w: int, th: int, tw: int):
    """(R, 3) row-major rays -> (nT, P, 3) row-major tiles + untile
    metadata (edge-padded to whole tiles)."""
    hp = (-res_h) % th
    wp = (-res_w) % tw
    img = d.reshape(res_h, res_w, 3)
    if hp or wp:
        img = jnp.pad(img, ((0, hp), (0, wp), (0, 0)), mode="edge")
    h2, w2 = res_h + hp, res_w + wp
    tiles = (img.reshape(h2 // th, th, w2 // tw, tw, 3)
             .transpose(0, 2, 1, 3, 4)
             .reshape(-1, th * tw, 3))
    return tiles, (h2, w2, th, tw)


def _untile(x: jax.Array, meta, res_h: int, res_w: int):
    """(nT, P) per-tile values -> (res_h, res_w) image order."""
    h2, w2, th, tw = meta
    full = (x.reshape(h2 // th, w2 // tw, th, tw).transpose(0, 2, 1, 3)
            .reshape(h2, w2))
    return full[:res_h, :res_w]


def _tile_frustum_visible(o: jax.Array, tile_dirs: jax.Array,
                          bmin: jax.Array, bmax: jax.Array,
                          th: int, tw: int):
    """Visibility of each cluster AABB from one tile's ray cone.

    tile_dirs: (P, 3) with P = th*tw, row-major within the tile.
    Directions are affine in pixel coords, so the 4 corner rays bound the
    cone; each frustum side plane passes through the origin.
    Returns (visible (C,), tnear (C,)).
    """
    p = tile_dirs
    c00 = p[0]
    c01 = p[tw - 1]
    c10 = p[(th - 1) * tw]
    c11 = p[th * tw - 1]
    center = p.mean(axis=0)
    # cyclic order around the cone
    corners = jnp.stack([c00, c01, c11, c10])
    nxt = jnp.stack([c01, c11, c10, c00])
    normals = vecmath.cross(corners, nxt)           # (4, 3)
    flip = jnp.sign(vecmath.dot(normals, center[None, :]))[:, None]
    normals = normals * jnp.where(flip == 0, 1.0, flip)
    # p-vertex test per plane: outside iff furthest corner is behind
    pvert = jnp.where(normals[:, None, :] > 0, bmax[None, :, :],
                      bmin[None, :, :])             # (4, C, 3)
    dist = jnp.einsum("pc,pnc->pn", normals, pvert - o[None, None, :],
                      precision=_HP)                # (4, C)
    visible = jnp.all(dist >= 0.0, axis=0)
    tnear = vecmath.dot((bmin + bmax) / 2.0 - o[None, :], center[None, :])
    return visible, tnear


def intersect_clustered(o: jax.Array, d: jax.Array, tris,
                        accel: ClusterAccel, config: RenderConfig,
                        res_h: int, res_w: int) -> Hit:
    """Nearest hit via tile frustum cull + dense per-tile MT.

    o: (3,) object-frame origin; d: (R, 3) object-frame unit dirs in
    row-major image order (R = res_h * res_w).
    """
    th, tw = config.tile_h, config.tile_w
    k = min(config.max_candidates, accel.num_clusters)
    ln = accel.leaf_size

    # per-frame, per-object fixed-origin MT constants for every slot
    tvec = o[None, :] - accel.p1
    m_det = vecmath.cross(accel.e2, accel.e1)       # (S, 3)
    m_u = vecmath.cross(accel.e2, tvec)
    m_v = vecmath.cross(tvec, accel.e1)
    tdet = vecmath.dot(accel.e2, m_v)               # (S,)

    tiles, meta = _tile_rays(d, res_h, res_w, th, tw)

    def per_tile(tile_d):
        visible, tnear = _tile_frustum_visible(
            o, tile_d, accel.bounds_min, accel.bounds_max, th, tw)
        key = jnp.where(visible, tnear, jnp.inf)
        _, cand = jax.lax.top_k(-key, k)            # (K,) nearest visible
        cand_valid = jnp.take(visible, cand)        # (K,)

        slot = (cand[:, None] * ln
                + jnp.arange(ln, dtype=jnp.int32)[None, :]).reshape(-1)
        sl_tri = jnp.where(jnp.repeat(cand_valid, ln),
                           jnp.take(accel.slot_tri, slot, axis=0),
                           jnp.int32(-1))           # (K*L,)
        md = jnp.take(m_det, slot, axis=0)
        mu = jnp.take(m_u, slot, axis=0)
        mv = jnp.take(m_v, slot, axis=0)
        td = jnp.take(tdet, slot, axis=0)

        det = jnp.dot(tile_d, md.T, precision=_HP)  # (P, K*L)
        ud = jnp.dot(tile_d, mu.T, precision=_HP)
        vd = jnp.dot(tile_d, mv.T, precision=_HP)
        inv = 1.0 / det
        u = ud * inv
        v = vd * inv
        t = td[None, :] * inv
        eps = config.eps
        ok = ((jnp.abs(det) >= eps) & (u >= eps) & (v >= eps)
              & (u + v <= 1.0 + eps) & (t >= eps)
              & (t < config.draw_distance) & (sl_tri[None, :] >= 0))
        t = jnp.where(ok, t, jnp.inf)
        tmin = jnp.min(t, axis=1)                   # (P,)
        amin = jnp.argmin(t, axis=1)
        tri = jnp.where(jnp.isfinite(tmin),
                        jnp.take(sl_tri, amin), jnp.int32(-1))
        overflow = jnp.maximum(
            jnp.sum(visible.astype(jnp.int32)) - k, 0)
        return (jnp.where(jnp.isfinite(tmin), tmin,
                          jnp.asarray(config.draw_distance, tmin.dtype)),
                tri, overflow)

    t_tiles, tri_tiles, overflow = jax.lax.map(
        per_tile, tiles, batch_size=8)

    t_flat = _untile(t_tiles, meta, res_h, res_w).reshape(-1)
    tri_flat = _untile(tri_tiles, meta, res_h, res_w).reshape(-1)
    return Hit(t=t_flat, tri=tri_flat,
               obj=jnp.where(tri_flat >= 0, 0, -1).astype(jnp.int32))


def _ray_table(proj, o, bmin, bmax, n_tiles: int, n_tx: int,
               th: int, tw: int, draw_distance: float) -> jax.Array:
    """(4, n_tiles*th*tw) f32 rows [dx | dy | dz | scene-exit bound] in
    row-major tile order — the bin kernel's ray table.

    Directions are the camera's own (`Projection.pixel_rays`) in the object
    frame. The bound is the far slab intersection with the object's root
    AABB (+eps), 0 when the ray misses the box entirely — the comparand of
    the kernel's exit certificate.
    """
    f32 = jnp.float32
    p = th * tw
    n = n_tiles * p
    idx = jnp.arange(n, dtype=jnp.int32)
    t = idx // p
    pi = idx - t * p
    ix = ((t % n_tx) * tw + pi % tw).astype(f32)
    iy = ((t // n_tx) * th + pi // tw).astype(f32)
    d0, d1, d2 = proj.pixel_rays(ix, iy)

    r_near = jnp.full((n,), -jnp.inf, f32)
    r_far = jnp.full((n,), jnp.inf, f32)
    for ax, dax in ((0, d0), (1, d1), (2, d2)):
        dsf = jnp.where(jnp.abs(dax) < 1e-30,
                        jnp.where(dax < 0, -1e-30, 1e-30), dax)
        inv = 1.0 / dsf
        ta = (bmin[ax] - o[ax]) * inv
        tb = (bmax[ax] - o[ax]) * inv
        r_near = jnp.maximum(r_near, jnp.minimum(ta, tb))
        r_far = jnp.minimum(r_far, jnp.maximum(ta, tb))
    root_hit = r_far >= jnp.maximum(r_near, 0.0) - 1e-4
    bnd = jnp.minimum(jnp.where(root_hit, r_far + 1e-3, 0.0),
                      f32(draw_distance))
    return jnp.stack([d0, d1, d2, bnd])


def intersect_binned(o: jax.Array, d: jax.Array, tris, proj,
                     config: RenderConfig, res_h: int, res_w: int,
                     interpret: bool | None = None):
    """Main path: screen-space tile binning (accel/binning.py) + the
    per-tile nearest-hit kernel (ops/pallas/bin_intersect.py).

    ``proj`` is the camera Projection already transformed into the
    object's frame; ``o`` is the object-frame origin. PRIMARY RAYS ONLY:
    each pixel's direction is regenerated from ``proj``'s basis, so ``d``
    is IGNORED — a caller passing custom/non-primary directions must use
    another method (it is kept in the signature so all trace_rays
    backends share one call shape). Bins are exact, so the only capacity
    limit is the global entry table (config.bin_e_factor). A full table
    self-heals: when the first pass overflows (would drop geometry — the
    reference's traversal is exact, Trixel.cu:70-169), a lax.cond re-bins
    at 2x e_cap and re-runs the kernel (config.bin_escalate; residual
    overflow past 2x is still reported in stats).

    With ``config.with_stats`` returns (Hit, stats) where stats holds the
    prepass counters: live ``entries``, ``overflow`` entries past the
    table, camera-plane-crossing triangles ``cross``.
    """
    del d  # primary rays are derived from proj (see docstring)
    from ..accel.binning import bin_triangles
    from ..ops.pallas.bin_intersect import (N_SUB, bin_intersect,
                                            interpret_default)

    if interpret is None:
        interpret = interpret_default()
    # the interpreter runs one grid step at a time: one program per tile
    n_sub = 1 if interpret else N_SUB
    th, tw = config.tile_h, config.tile_w
    chunk = config.bin_chunk
    t_n = tris.p1x.shape[0]
    e_cap = int(t_n * config.bin_e_factor) + 8192
    e_cap = -(-e_cap // chunk) * chunk

    hp, wp = (-res_h) % th, (-res_w) % tw
    h2, w2 = res_h + hp, res_w + wp
    meta = (h2, w2, th, tw)
    n_tx = w2 // tw
    n_tiles = (h2 // th) * n_tx

    # componentized object AABB over the flat (T,) fields
    bmin, bmax = [], []
    for v1, d1, d2 in ((tris.p1x, tris.e1x, tris.e2x),
                       (tris.p1y, tris.e1y, tris.e2y),
                       (tris.p1z, tris.e1z, tris.e2z)):
        v2, v3 = v1 + d1, v1 + d2
        bmin.append(jnp.min(jnp.minimum(jnp.minimum(v1, v2), v3)))
        bmax.append(jnp.max(jnp.maximum(jnp.maximum(v1, v2), v3)))
    rays = _ray_table(proj, o, jnp.stack(bmin), jnp.stack(bmax), n_tiles,
                      n_tx, th, tw, config.draw_distance)

    def bin_and_run(cap):
        binned = bin_triangles(proj, o,
                               (tris.p1x, tris.p1y, tris.p1z),
                               (tris.e1x, tris.e1y, tris.e1z),
                               (tris.e2x, tris.e2y, tris.e2z),
                               h2, w2, th, tw,
                               e_cap=cap, chunk=chunk, eps=config.eps,
                               backface_cull=config.backface_cull)
        t, tri = bin_intersect(
            binned.starts, rays, binned.geom, p=th * tw,
            n_sub=n_sub, chunk=chunk, eps=config.eps,
            draw_distance=config.draw_distance, interpret=interpret)
        return (t, tri, binned.overflow_entries, binned.num_entries,
                binned.cross_tris)

    t, tri, overflow, entries, cross = bin_and_run(e_cap)
    if config.bin_escalate:
        # capacity escalation: geometry must never silently drop. Both
        # branches compile; at runtime the 2x re-bin executes only on
        # the (rare) overflowing frame.
        t, tri, overflow, entries, cross = jax.lax.cond(
            overflow > 0, lambda: bin_and_run(2 * e_cap),
            lambda: (t, tri, overflow, entries, cross))

    p = th * tw
    t_flat = _untile(t.reshape(n_tiles, p), meta, res_h, res_w).reshape(-1)
    tri_flat = _untile(tri.reshape(n_tiles, p), meta, res_h,
                       res_w).reshape(-1)
    hit = Hit(t=t_flat, tri=tri_flat,
              obj=jnp.where(tri_flat >= 0, 0, -1).astype(jnp.int32))
    if config.with_stats:
        return hit, {"overflow": overflow, "entries": entries,
                     "cross": cross}
    return hit



@pytree_dataclass
class KDTables:
    """Device-resident flattened KD tree (any leaf width) — the analogue of
    the per-camera voxel tables built by init_cam_voxel_mem_cuda
    (Camera.cu:137-162), minus the camera-relative re-centering: we keep
    boxes in the object frame and transform rays instead."""

    bounds_min: jax.Array   # (N, 3)
    bounds_max: jax.Array   # (N, 3)
    axis: jax.Array         # (N,) int32 cut axis 0/1/2
    s1: jax.Array           # (N,)
    s2: jax.Array           # (N,)
    left: jax.Array         # (N,)
    right: jax.Array        # (N,)
    is_leaf: jax.Array      # (N,) bool
    leaf_start: jax.Array   # (N,)
    leaf_count: jax.Array   # (N,)
    # permuted slot geometry so leaves are contiguous
    p1: jax.Array           # (T, 3)
    e1: jax.Array           # (T, 3)
    e2: jax.Array           # (T, 3)
    perm: jax.Array         # (T,) original tri ids
    max_depth: int = static_field()
    max_leaf: int = static_field()

    @classmethod
    def from_tree(cls, tree: KDTree, tris) -> "KDTables":
        perm = tree.perm
        return cls(
            bounds_min=jnp.asarray(tree.bounds_min),
            bounds_max=jnp.asarray(tree.bounds_max),
            axis=jnp.asarray(tree.cut_code % 3, jnp.int32),
            s1=jnp.asarray(tree.s1), s2=jnp.asarray(tree.s2),
            left=jnp.asarray(tree.left), right=jnp.asarray(tree.right),
            is_leaf=jnp.asarray(tree.is_leaf),
            leaf_start=jnp.asarray(tree.leaf_start),
            leaf_count=jnp.asarray(tree.leaf_count),
            p1=jnp.asarray(np.asarray(tris.p1)[perm]),
            e1=jnp.asarray(np.asarray(tris.e1)[perm]),
            e2=jnp.asarray(np.asarray(tris.e2)[perm]),
            perm=jnp.asarray(perm, jnp.int32),
            max_depth=tree.max_depth,
            max_leaf=int(tree.leaf_count.max()),
        )


def kd_intersect(o: jax.Array, d: jax.Array, tables: KDTables,
                 draw_distance: float = 400.0,
                 eps: float = MT_EPSILON,
                 ray_chunk: int = 32768) -> Hit:
    """Reference-semantics stack traversal, lockstep-vectorized over rays.

    Per iteration each ray pops one node, slab-tests it
    (Trixel.cu:76-95), intersects its triangles if it is a leaf
    (Trixel.cu:98-145), else pushes children ordered by the s1/s2
    split-plane rule (Trixel.cu:146-169). Runs until every ray's stack is
    empty. Validation path — O(depth) state per ray, heavy gathers.

    Scope: this path is the semantic oracle for the reference's traversal
    rules (validated against the brute oracle, tests/test_kd.py), not the
    performance path; full-image validation at scale uses the brute-force
    `fixed` oracle (the role the reference's own ground-truth kernel
    plays, Trixel.cu:173-209). Rays are processed in ``ray_chunk`` slabs
    to bound live per-ray state (stack + leaf gathers); set ray_chunk=0
    to disable.
    """
    num_r = d.shape[0]
    if ray_chunk and num_r > ray_chunk:
        pad = (-num_r) % ray_chunk
        d_pad = jnp.concatenate(
            [d, jnp.broadcast_to(d[:1], (pad, 3))]) if pad else d
        slabs = d_pad.reshape(-1, ray_chunk, 3)
        hits = jax.lax.map(
            lambda ds: kd_intersect(o, ds, tables, draw_distance, eps,
                                    ray_chunk=0), slabs)
        return Hit(t=hits.t.reshape(-1)[:num_r],
                   tri=hits.tri.reshape(-1)[:num_r],
                   obj=hits.obj.reshape(-1)[:num_r])
    depth = tables.max_depth + 2
    lmax = tables.max_leaf

    stack = jnp.zeros((num_r, depth), jnp.int32)
    sp = jnp.zeros((num_r,), jnp.int32)  # stack[0] = root, sp = top index
    best_t = jnp.full((num_r,), draw_distance, d.dtype)
    best_tri = jnp.full((num_r,), -1, jnp.int32)

    inv_d = 1.0 / d

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp >= 0)

    def body(state):
        stack, sp, best_t, best_tri = state
        active = sp >= 0
        node = stack[jnp.arange(num_r), jnp.maximum(sp, 0)]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        nb_min = jnp.take(tables.bounds_min, node, axis=0)  # (R, 3)
        nb_max = jnp.take(tables.bounds_max, node, axis=0)
        t0 = (nb_min - o[None, :]) * inv_d
        t1 = (nb_max - o[None, :]) * inv_d
        t_lo = jnp.minimum(t0, t1)
        t_hi = jnp.maximum(t0, t1)
        t_entry = jnp.max(t_lo, axis=-1)
        t_exit = jnp.min(t_hi, axis=-1)
        # Trixel.cu:146: mint1 >= maxt0 - eps && maxt0 > -eps
        box_hit = (t_exit >= t_entry - SLAB_EPSILON) & \
                  (t_entry > -SLAB_EPSILON)

        leaf = jnp.take(tables.is_leaf, node)
        # --- leaf: masked MT over the leaf's (padded) triangle range ---
        start = jnp.take(tables.leaf_start, node)
        count = jnp.take(tables.leaf_count, node)
        slot = start[:, None] + jnp.arange(lmax, dtype=jnp.int32)[None, :]
        in_leaf = jnp.arange(lmax, dtype=jnp.int32)[None, :] < count[:, None]
        slot = jnp.where(in_leaf, slot, 0)
        p1 = jnp.take(tables.p1, slot.reshape(-1), axis=0
                      ).reshape(num_r, lmax, 3)
        e1 = jnp.take(tables.e1, slot.reshape(-1), axis=0
                      ).reshape(num_r, lmax, 3)
        e2 = jnp.take(tables.e2, slot.reshape(-1), axis=0
                      ).reshape(num_r, lmax, 3)
        from ..ops.intersect import mt_test
        t_mt, _, _, ok = mt_test(o[None, None, :], d[:, None, :],
                                 p1, e1, e2, eps)
        t_mt = jnp.where(in_leaf & ok & active[:, None] & leaf[:, None],
                         t_mt, jnp.inf)
        tmin = jnp.min(t_mt, axis=1)
        amin = jnp.argmin(t_mt, axis=1)
        tri = jnp.take(tables.perm,
                       jnp.take_along_axis(slot, amin[:, None], 1)[:, 0])
        better = tmin < best_t
        best_t = jnp.where(better, tmin, best_t)
        best_tri = jnp.where(better, tri, best_tri)

        # --- internal: push children near-to-far (reference s1/s2 rule) ---
        axis = jnp.take(tables.axis, node)
        d_ax = jnp.take_along_axis(d, axis[:, None], 1)[:, 0]
        o_ax = o[axis]
        c_entry = o_ax + t_entry * d_ax
        c_exit = o_ax + t_exit * d_ax
        s1 = jnp.take(tables.s1, node) + SLAB_EPSILON
        s2 = jnp.take(tables.s2, node)
        lchild = jnp.take(tables.left, node)
        rchild = jnp.take(tables.right, node)

        go_left_first = c_entry < s2 + SLAB_EPSILON   # Trixel.cu:155
        also_right = c_exit > s2 - SLAB_EPSILON       # Trixel.cu:156
        also_left = (c_exit < s1) | (c_entry < s1)    # Trixel.cu:163

        expand = active & box_hit & ~leaf
        # push far child first, near child last (popped first)
        far = jnp.where(go_left_first, rchild, lchild)
        near = jnp.where(go_left_first, lchild, rchild)
        push_far = expand & jnp.where(go_left_first, also_right, also_left)
        push_near = expand

        sp = jnp.where(push_far, sp + 1, sp)
        stack = stack.at[jnp.arange(num_r), jnp.clip(sp, 0, depth - 1)].set(
            jnp.where(push_far, far, stack[jnp.arange(num_r),
                                           jnp.clip(sp, 0, depth - 1)]))
        sp = jnp.where(push_near, sp + 1, sp)
        stack = stack.at[jnp.arange(num_r), jnp.clip(sp, 0, depth - 1)].set(
            jnp.where(push_near, near, stack[jnp.arange(num_r),
                                             jnp.clip(sp, 0, depth - 1)]))
        return stack, sp, best_t, best_tri

    _, _, best_t, best_tri = jax.lax.while_loop(
        cond, body, (stack, sp, best_t, best_tri))
    return Hit(t=best_t, tri=best_tri,
               obj=jnp.where(best_tri >= 0, 0, -1).astype(jnp.int32))
