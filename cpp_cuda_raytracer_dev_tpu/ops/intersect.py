"""Möller–Trumbore ray/triangle intersection, vectorized over batches.

Replaces the reference's per-thread branchy intersectors — the brute-force
``intersect_trixel_cuda`` (``TEST_Dungeonrun/Trixel.cu:173-209``) and the MT
inner loop of the KD traversal kernel (``Trixel.cu:101-142``) — with dense
(rays x triangles) batches:

- `mt_brute` is the ground-truth oracle: every ray against every triangle,
  chunked over triangles with `lax.scan` to bound memory, nearest valid hit
  kept by masked min-reduction (role of intersect_trixel_cuda as the debug /
  golden path).
- `FixedOriginCache` + `mt_fixed_origin` exploit that all primary rays share
  one origin per (camera, object) pair — the reference's camera-space
  triangle cache d_t/d_q/d_w (Trixel.cu:29-36). In that regime the three MT
  determinants become *matmuls* against per-triangle constant vectors:

      det[r,t]   = d[r] . (e2 x e1)[t]
      u*det[r,t] = d[r] . (e2 x (o - p1))[t]
      v*det[r,t] = d[r] . ((o - p1) x e1)[t]      (reference's d_q)
      t*det[t]   = e2 . ((o - p1) x e1)[t]        (reference's d_w, ray-free)

  i.e. one (R,3) @ (3,3T) contraction + elementwise acceptance instead of a
  per-thread scalar loop.

Acceptance test matches the reference exactly (Trixel.cu:106,127):
reject when |det| < eps, or u < eps, or v < eps, or u+v > 1+eps, or t < eps,
or t >= current best; eps = 1e-16 (vector.cuh:10-13).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.dtypes import DEFAULT_DRAW_DISTANCE, MT_EPSILON
from ..utils.pytree import pytree_dataclass
from . import vecmath


@pytree_dataclass
class Hit:
    """Per-ray nearest-hit record (the written-back fields of pixel_memory:
    d_rmi, d_dist — Trixel.cu:129-139)."""

    t: jax.Array        # (R,) hit distance, draw_distance when missed
    tri: jax.Array      # (R,) int32 triangle index, -1 on miss
    obj: jax.Array      # (R,) int32 object index, -1 on miss

    @property
    def valid(self) -> jax.Array:
        return self.tri >= 0

    @classmethod
    def miss(cls, num_rays: int,
             draw_distance: float = DEFAULT_DRAW_DISTANCE,
             dtype=jnp.float32) -> "Hit":
        return cls(
            t=jnp.full((num_rays,), draw_distance, dtype),
            tri=jnp.full((num_rays,), -1, jnp.int32),
            obj=jnp.full((num_rays,), -1, jnp.int32),
        )

    def merge(self, other: "Hit") -> "Hit":
        """Nearest-hit combine of two hit sets over the same rays — used
        across objects, triangle chunks, and (sharded) primitive ranges."""
        take_other = other.t < self.t
        return Hit(
            t=jnp.where(take_other, other.t, self.t),
            tri=jnp.where(take_other, other.tri, self.tri),
            obj=jnp.where(take_other, other.obj, self.obj),
        )


def mt_test(o, d, p1, e1, e2, eps: float = MT_EPSILON):
    """Elementwise MT test with full broadcasting.

    o, d: (..., 3) ray origins/directions; p1, e1, e2: (..., 3) triangles
    (shapes must broadcast). Returns (t, u, v, valid); t is +inf where
    invalid. This is the differentiable core reused by the backward pass.
    """
    pvec = vecmath.cross(d, e2)
    det = vecmath.dot(e1, pvec)
    tvec = o - p1
    qvec = vecmath.cross(tvec, e1)
    # guarded division: det == 0 lanes are rejected by |det| >= eps below,
    # so the substitute value never reaches an accepted output — the guard
    # only keeps checkify float_checks (utils/debug.py) free of false
    # positives from masked-SIMD lanes.
    inv = 1.0 / jnp.where(det == 0.0, 1.0, det)
    u = inv * vecmath.dot(tvec, pvec)
    v = inv * vecmath.dot(d, qvec)
    t = inv * vecmath.dot(e2, qvec)
    valid = (
        (jnp.abs(det) >= eps)
        & (u >= eps) & (v >= eps)
        & (u + v <= 1.0 + eps)
        & (t >= eps)
    )
    return jnp.where(valid, t, jnp.inf), u, v, valid


def mt_brute(o: jax.Array, d: jax.Array, tris,
             draw_distance: float = DEFAULT_DRAW_DISTANCE,
             eps: float = MT_EPSILON, chunk: int = 4096) -> Hit:
    """Every ray vs every triangle; nearest valid hit below draw_distance.

    o: (3,) shared origin or (R, 3); d: (R, 3). Triangle dimension is chunked
    with lax.scan carrying the running best so peak memory is R*chunk.
    Ground-truth oracle (role of intersect_trixel_cuda, Trixel.cu:173-209).
    """
    num_r = d.shape[0]
    num_t = tris.num_triangles
    o = jnp.broadcast_to(jnp.asarray(o, d.dtype), d.shape)

    pad = (-num_t) % chunk
    def padded(x):
        return jnp.concatenate(
            [x, jnp.full((pad, 3), jnp.nan, x.dtype)]) if pad else x
    p1 = padded(tris.p1).reshape(-1, chunk, 3)
    e1 = padded(tris.e1).reshape(-1, chunk, 3)
    e2 = padded(tris.e2).reshape(-1, chunk, 3)

    def step(best, args):
        ci, (p1c, e1c, e2c) = args
        t, _, _, _ = mt_test(o[:, None, :], d[:, None, :],
                             p1c[None], e1c[None], e2c[None], eps)  # (R, C)
        tmin = jnp.min(t, axis=1)
        amin = jnp.argmin(t, axis=1).astype(jnp.int32) + ci * chunk
        cand = Hit(t=jnp.where(tmin < best.t, tmin, best.t),
                   tri=jnp.where(tmin < best.t, amin, best.tri),
                   obj=best.obj)
        return cand, None

    init = Hit(t=jnp.full((num_r,), draw_distance, d.dtype),
               tri=jnp.full((num_r,), -1, jnp.int32),
               obj=jnp.full((num_r,), -1, jnp.int32))
    nchunks = p1.shape[0]
    best, _ = jax.lax.scan(
        step, init,
        (jnp.arange(nchunks, dtype=jnp.int32), (p1, e1, e2)))
    return best


@pytree_dataclass
class FixedOriginCache:
    """Per-(origin, object) triangle constants for the matmul-form MT — the
    batched equivalent of Camera::trixel_memory d_t/d_q/d_w
    (Camera.h:64-68, built by init_cam_tri_mem_cuda, Trixel.cu:29-36).

    m is (3, 3T): columns [e2 x e1 | e2 x tvec | tvec x e1] interleaved per
    triangle block; tdet is (T,) = e2 . (tvec x e1).
    """

    m_det: jax.Array   # (T, 3) = cross(e2, e1)
    m_u: jax.Array     # (T, 3) = cross(e2, o - p1)
    m_v: jax.Array     # (T, 3) = cross(o - p1, e1)   (reference d_q)
    tdet: jax.Array    # (T,)   = dot(e2, m_v)         (reference d_w)

    @classmethod
    def build(cls, origin: jax.Array, tris
              ) -> "FixedOriginCache":
        tvec = origin[None, :] - tris.p1
        m_v = vecmath.cross(tvec, tris.e1)
        return cls(
            m_det=vecmath.cross(tris.e2, tris.e1),
            m_u=vecmath.cross(tris.e2, tvec),
            m_v=m_v,
            tdet=vecmath.dot(tris.e2, m_v),
        )


def mt_fixed_origin(d: jax.Array, cache: FixedOriginCache,
                    draw_distance: float = DEFAULT_DRAW_DISTANCE,
                    eps: float = MT_EPSILON, chunk: int = 2048) -> Hit:
    """Nearest hit for rays sharing one origin, via (R,3)@(3,T) matmuls.

    d: (R, 3) unit directions in the object frame: three contractions,
    then elementwise acceptance + min-reduce.
    """
    num_t = cache.tdet.shape[0]
    pad = (-num_t) % chunk

    def padv(x):
        return jnp.concatenate(
            [x, jnp.zeros((pad, 3), x.dtype)]) if pad else x
    m_det = padv(cache.m_det).reshape(-1, chunk, 3)
    m_u = padv(cache.m_u).reshape(-1, chunk, 3)
    m_v = padv(cache.m_v).reshape(-1, chunk, 3)
    tdet = (jnp.concatenate([cache.tdet, jnp.zeros((pad,), cache.tdet.dtype)])
            if pad else cache.tdet).reshape(-1, chunk)

    num_r = d.shape[0]

    def step(best, args):
        ci, (mdc, muc, mvc, tdc) = args
        # precision=HIGHEST: a reduced-precision float32 matmul (TF32 on a
        # GPU) visibly quantizes hit distances — the oracle needs full f32.
        hp = jax.lax.Precision.HIGHEST
        det = jnp.dot(d, mdc.T, precision=hp,
                      preferred_element_type=d.dtype)  # (R, C)
        ud = jnp.dot(d, muc.T, precision=hp,
                     preferred_element_type=d.dtype)
        vd = jnp.dot(d, mvc.T, precision=hp,
                     preferred_element_type=d.dtype)
        inv = 1.0 / jnp.where(det == 0.0, 1.0, det)  # masked lanes only
        u = ud * inv
        v = vd * inv
        t = tdc[None, :] * inv
        valid = ((jnp.abs(det) >= eps) & (u >= eps) & (v >= eps)
                 & (u + v <= 1.0 + eps) & (t >= eps))
        t = jnp.where(valid, t, jnp.inf)
        tmin = jnp.min(t, axis=1)
        amin = jnp.argmin(t, axis=1).astype(jnp.int32) + ci * chunk
        better = tmin < best.t
        return Hit(t=jnp.where(better, tmin, best.t),
                   tri=jnp.where(better, amin, best.tri),
                   obj=best.obj), None

    init = Hit(t=jnp.full((num_r,), draw_distance, d.dtype),
               tri=jnp.full((num_r,), -1, jnp.int32),
               obj=jnp.full((num_r,), -1, jnp.int32))
    best, _ = jax.lax.scan(
        step, init,
        (jnp.arange(m_det.shape[0], dtype=jnp.int32),
         (m_det, m_u, m_v, tdet)))
    return best
