"""Vector math primitives over ``(..., 3)`` arrays.

JAX replacement for the reference's host/device vector libraries
(``TEST_Dungeonrun/Vector.h``, ``vector.cpp``, ``vector.cuh``). The reference
carries scalar SoA pointers and a Quake-style inverse sqrt with Newton
refinement (``vector.cpp:13-26``, ``vector.cuh:79-95``); here everything is a
batched jnp op XLA vectorizes directly, and ``jax.lax.rsqrt`` replaces the
bit-trick (``quake_rsqrt`` is kept for numerical-parity tests only).

All functions are shape-polymorphic over leading batch dims and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 3D dot product -> (...,). Ref: vector.cuh device_dot."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 3D cross product. Ref: vector.cuh device_cross / VEC4::cross
    (vector.cpp:31-36): (ay*bz-az*by, az*bx-ax*bz, ax*by-ay*bx)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx), axis=-1
    )


def norm(a: jax.Array) -> jax.Array:
    """Euclidean norm over the last axis."""
    return jnp.sqrt(dot(a, a))


def normalize(a: jax.Array, eps: float = 0.0) -> jax.Array:
    """Unit vector along ``a``; hardware rsqrt instead of the reference's
    Quake bit-trick + 8 Newton steps (vector.cpp:13-26)."""
    s = dot(a, a)
    if eps:
        s = jnp.maximum(s, eps)
    return a * jax.lax.rsqrt(s)[..., None]


def normalize_with_invnorm(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(unit vector, inverse norm). The reference's ``normalize_Vector``
    stores 1/|v| in the ``w`` slot (Vector.h:253-261); callers here get it as
    a separate array."""
    inv = jax.lax.rsqrt(dot(a, a))
    return a * inv[..., None], inv


def quake_rsqrt(s: jax.Array, newton_iters: int = 8) -> jax.Array:
    """Bit-trick inverse sqrt matching ``vector_norm`` (vector.cpp:13-26):
    magic constant 0x5f375a86 then ``newton_iters`` Newton refinements.

    Kept only to validate that plain rsqrt is at least as accurate; never
    used in the render path (the hardware has a native rsqrt).
    """
    s = jnp.asarray(s, jnp.float32)
    half = 0.5 * s
    i = jax.lax.bitcast_convert_type(half, jnp.int32)
    i = jnp.int32(0x5F375A86) - (i >> 1)
    x = jax.lax.bitcast_convert_type(i, jnp.float32)
    for _ in range(newton_iters):
        x = x * (1.5 - half * x * x)
    return x


def reflect(v: jax.Array, n: jax.Array) -> jax.Array:
    """Reflect ``v`` about unit normal ``n``: v - 2 (v.n) n.

    The Phong kernel computes this inline (Camera.cu:39-41)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def sign_bits(a: jax.Array) -> jax.Array:
    """1 where the float's sign bit is set, else 0 (per component).

    Analogue of ``sign_rmd`` (Camera.cu:107: raw bits shifted by
    precision_shift)."""
    return (a < 0).astype(jnp.int32)
