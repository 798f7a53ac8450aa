"""Scatter-min z-buffer rasterization — primary-ray intersection without a
sort, a kernel, or per-tile segments (method="raster").

The reference answers "nearest triangle along each primary ray" by walking a
KD tree per ray (``TEST_Dungeonrun/Trixel.cu:41-172``). For a pinhole camera
this question IS rasterization: a pixel's ray can hit only triangles whose
projection covers the pixel center, so instead of culling per ray we
enumerate, per triangle, the handful of pixels its projected bbox covers and
z-combine with two scatter-mins.

The trick that keeps acceptance EXACT (same accept/reject as the
brute-force oracle, ops/intersect.py): every primary ray direction is
affine in pixel coordinates,

    D(ix, iy) = n + (ix - ax)/sx * u + (iy - ay)/sy * v

(models/camera.py Projection.pixel_rays before normalization, = the
reference's n_mod/u_mod/v_mod ray gen, ``Camera.cu:103-104``, scaled by
1/focal), so every Möller–Trumbore
contraction D·m is affine in (ix, iy) too:

    det(ix,iy) = n·m_det + (ix-ax)/sx * u·m_det + (iy-ay)/sy * v·m_det

with the fixed-origin per-triangle constants m_det/m_u/m_v/tdet
(FixedOriginCache = the reference's camera-space cache, Trixel.cu:29-36).
Per (triangle, candidate pixel) the full MT test is ~15 scalar ops — no
matmul, no per-ray loop. u = ud/det and v = vd/det are invariant to the
|D| scaling, and t_aff = td/det scales by the SAME 1/|D| for every
triangle at a given pixel, so per-pixel nearest-hit order is preserved;
the true distance is recovered as t_aff * |D(ix,iy)| with
|D|^2 = 1 + ((ix-ax)/sx)^2 + ((iy-ay)/sy)^2 (n,u,v orthonormal).

Winner selection is two exact scatter-mins:
  1. zmin[pix]  = min over covering pairs of bitcast(t_aff)   (f32 bits of
     a positive float order like the float),
  2. tri[pix]   = min tri id among pairs with bits == zmin[pix] (ties on
     exactly equal t break to the lowest triangle id, matching the
     oracle's argmin).

Triangles whose projected bbox exceeds the static `span` cap, or that cross
the camera plane (a vertex behind the origin), are routed to a dense
matmul-MT pass over a static-capacity list (`ovf_cap`) against all rays —
exact, and empty for small-triangle meshes; overflow beyond the cap is
counted and surfaced in stats (never silently dropped geometry —
the reference's traversal is exact, Trixel.cu:70-169, so ours must be).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.intersect import FixedOriginCache, Hit
from ..utils.config import RenderConfig

BIG = 3.0e38
_MAXI = 2**31 - 1


def intersect_raster(o: jax.Array, d: jax.Array, tris, proj,
                     config: RenderConfig, res_h: int, res_w: int):
    """Nearest hit per pixel by scatter-min rasterization.

    o: (3,) object-frame origin (must equal proj.origin); d: (R, 3) unit
    object-frame dirs, row-major (R = res_h*res_w); proj: Projection in the
    object frame. Returns Hit (and stats dict when config.with_stats).
    """
    f32 = jnp.float32
    t_n = tris.p1.shape[0]
    npix = res_h * res_w
    span = config.raster_span
    guard = 0.5

    p1, e1, e2 = tris.p1, tris.e1, tris.e2
    cache = FixedOriginCache.build(proj.origin, tris)

    # ---- projection of the 3 verts (matmul form, see accel/binning.py) ----
    # float32 products at full precision (a GPU may otherwise run them
    # in TF32, which moves projected pixel coordinates)
    hp = jax.lax.Precision.HIGHEST
    basis = jnp.stack([proj.n, proj.u, proj.v], axis=1)     # (3, 3)
    abc0 = jnp.dot(p1 - proj.origin[None, :], basis, precision=hp)
    dabc1 = jnp.dot(e1, basis, precision=hp)                # (T, 3)
    dabc2 = jnp.dot(e2, basis, precision=hp)
    a = jnp.stack([abc0[:, 0], abc0[:, 0] + dabc1[:, 0],
                   abc0[:, 0] + dabc2[:, 0]], axis=1)       # (T, 3)
    b = jnp.stack([abc0[:, 1], abc0[:, 1] + dabc1[:, 1],
                   abc0[:, 1] + dabc2[:, 1]], axis=1)
    c = jnp.stack([abc0[:, 2], abc0[:, 2] + dabc1[:, 2],
                   abc0[:, 2] + dabc2[:, 2]], axis=1)

    all_front = jnp.all(a > 0.0, axis=1)
    a_safe = jnp.maximum(a, 1e-20)
    px = proj.adjust_x + proj.sx * (b / a_safe)             # (T, 3)
    py = proj.adjust_y + proj.sy * (c / a_safe)
    x0 = jnp.min(px, axis=1) - guard
    x1 = jnp.max(px, axis=1) + guard
    y0 = jnp.min(py, axis=1) - guard
    y1 = jnp.max(py, axis=1) + guard
    ix0 = jnp.clip(jnp.ceil(x0), 0, res_w - 1).astype(jnp.int32)
    ix1 = jnp.floor(jnp.clip(x1, 0, res_w - 1)).astype(jnp.int32)
    iy0 = jnp.clip(jnp.ceil(y0), 0, res_h - 1).astype(jnp.int32)
    iy1 = jnp.floor(jnp.clip(y1, 0, res_h - 1)).astype(jnp.int32)
    onscreen = (all_front & (x1 >= 0) & (x0 <= res_w - 1)
                & (y1 >= 0) & (y0 <= res_h - 1)
                & (ix1 >= ix0) & (iy1 >= iy0))
    nx = ix1 - ix0 + 1
    ny = iy1 - iy0 + 1
    fits = (nx <= span) & (ny <= span)
    live = onscreen & fits

    # ---- affine MT coefficients per triangle ----
    isx = 1.0 / proj.sx
    isy = 1.0 / proj.sy
    nuv = jnp.stack([proj.n, proj.u * isx, proj.v * isy], axis=0)  # (3, 3)
    cd = jnp.dot(cache.m_det, nuv.T, precision=hp)          # (T, 3) A,Bu,Bv
    cu = jnp.dot(cache.m_u, nuv.T, precision=hp)
    cv = jnp.dot(cache.m_v, nuv.T, precision=hp)
    td = cache.tdet                                         # (T,)
    fx0 = ix0.astype(f32) - proj.adjust_x                   # (T,)
    fy0 = iy0.astype(f32) - proj.adjust_y
    det0 = cd[:, 0] + fx0 * cd[:, 1] + fy0 * cd[:, 2]
    ud0 = cu[:, 0] + fx0 * cu[:, 1] + fy0 * cu[:, 2]
    vd0 = cv[:, 0] + fx0 * cv[:, 1] + fy0 * cv[:, 2]

    eps = config.eps
    pix_base = iy0 * res_w + ix0

    # ---- evaluate MT at the span x span candidate grid, collect pairs ----
    pix_all = []
    bits_all = []
    for dy in range(span):
        for dx in range(span):
            det = det0 + dx * cd[:, 1] + dy * cd[:, 2]      # (T,)
            ud = ud0 + dx * cu[:, 1] + dy * cu[:, 2]
            vd = vd0 + dx * cv[:, 1] + dy * cv[:, 2]
            inv = 1.0 / det
            u = ud * inv
            v = vd * inv
            t = td * inv
            ok = (live & (dx < nx) & (dy < ny)
                  & (jnp.abs(det) >= eps) & (u >= eps) & (v >= eps)
                  & (u + v <= 1.0 + eps) & (t >= eps))
            pix_all.append(jnp.where(ok, pix_base + dy * res_w + dx, npix))
            bits_all.append(jnp.where(
                ok, jax.lax.bitcast_convert_type(t, jnp.int32), _MAXI))
    pix = jnp.concatenate(pix_all)                          # (span^2 * T,)
    bits = jnp.concatenate(bits_all)

    # ---- two-pass exact scatter-min z-buffer ----
    zmin = jnp.full((npix + 1,), _MAXI, jnp.int32).at[pix].min(
        bits, mode="drop")
    eq = bits == jnp.take(zmin, pix)
    tri_id = jnp.tile(jnp.arange(t_n, dtype=jnp.int32), span * span)
    win = jnp.full((npix + 1,), _MAXI, jnp.int32).at[
        jnp.where(eq, pix, npix)].min(tri_id, mode="drop")

    zmin = zmin[:npix]
    win = win[:npix]
    t_aff = jax.lax.bitcast_convert_type(zmin, f32)
    # |D| per pixel: n,u,v orthonormal => |D|^2 = 1 + fx^2 + fy^2
    ixg = jnp.arange(res_w, dtype=f32) - proj.adjust_x
    iyg = jnp.arange(res_h, dtype=f32) - proj.adjust_y
    d2 = (1.0 + (ixg[None, :] * isx) ** 2
          + (iyg[:, None] * isy) ** 2).reshape(-1)
    t_true = t_aff * jnp.sqrt(d2)
    hit_ok = (zmin != _MAXI) & (t_true < config.draw_distance)
    hit = Hit(
        t=jnp.where(hit_ok, t_true, f32(config.draw_distance)),
        tri=jnp.where(hit_ok, win, -1),
        obj=jnp.where(hit_ok, 0, -1).astype(jnp.int32),
    )

    # ---- overflow pass: big-span / camera-plane-crossing triangles ----
    ovf_mask = onscreen & ~fits | (jnp.any(a <= 0.0, axis=1)
                                   & jnp.any(a > 0.0, axis=1))
    n_ovf = jnp.sum(ovf_mask.astype(jnp.int32))
    cap = config.raster_ovf_cap

    def dense_pass(k):
        """Exact matmul-MT over the k highest-id overflow triangles."""
        score = jnp.where(ovf_mask, jnp.arange(t_n, dtype=jnp.int32), -1)
        _, sel = jax.lax.top_k(score, min(k, t_n))          # (k,)
        sel_ok = jnp.take(ovf_mask, sel)
        md = jnp.where(sel_ok[:, None], jnp.take(cache.m_det, sel, axis=0),
                       0.0)
        mu = jnp.where(sel_ok[:, None], jnp.take(cache.m_u, sel, axis=0),
                       0.0)
        mv = jnp.where(sel_ok[:, None], jnp.take(cache.m_v, sel, axis=0),
                       0.0)
        tdc = jnp.where(sel_ok, jnp.take(td, sel), 0.0)
        det = jnp.dot(d, md.T, precision=hp)                # (R, k)
        ud = jnp.dot(d, mu.T, precision=hp)
        vd = jnp.dot(d, mv.T, precision=hp)
        inv = 1.0 / det
        u = ud * inv
        v = vd * inv
        t = tdc[None, :] * inv
        okm = ((jnp.abs(det) >= eps) & (u >= eps) & (v >= eps)
               & (u + v <= 1.0 + eps) & (t >= eps))
        t = jnp.where(okm, t, jnp.inf)
        tmin = jnp.min(t, axis=1)
        # ties on exactly equal t break to the LOWEST triangle id (the
        # oracle's argmin-first semantics); sel is in descending-id order
        # from top_k, so a plain argmin would pick the highest id
        win = jnp.min(jnp.where(t == tmin[:, None], sel[None, :], _MAXI),
                      axis=1)
        return Hit(
            t=jnp.where(jnp.isfinite(tmin), tmin,
                        f32(config.draw_distance)),
            tri=jnp.where(jnp.isfinite(tmin), win, -1),
            obj=jnp.where(jnp.isfinite(tmin), 0, -1).astype(jnp.int32))

    residual = jnp.zeros((), jnp.int32)
    if cap > 0:
        # capacity self-healing (same pattern as intersect_binned): when
        # the overflow list exceeds the static cap — a close-up camera
        # routes MANY triangles here — a lax.cond re-runs the dense pass
        # at 4x capacity instead of silently dropping geometry. Residual
        # past 4x is still counted loudly in stats.
        cap4 = min(4 * cap, t_n)
        o_hit = jax.lax.cond(n_ovf > cap,
                             lambda _: dense_pass(cap4),
                             lambda _: dense_pass(cap), operand=None)
        residual = jnp.maximum(n_ovf - cap4, 0)
        hit = hit.merge(o_hit)
    else:
        residual = n_ovf

    if config.with_stats:
        return hit, {
            "overflow": residual,
            "ovf_tris": n_ovf,
            "pairs": jnp.sum((pix < npix).astype(jnp.int32)),
        }
    return hit
