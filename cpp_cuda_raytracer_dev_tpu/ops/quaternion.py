"""Quaternion algebra and rigid-body poses as JAX pytrees.

JAX replacement for the reference's ``Quaternion`` class
(``TEST_Dungeonrun/Quaternion.h/.cpp/.cu``). The reference stores a unit
quaternion plus a 3x4 row matrix whose ``w`` column accumulates translation,
mutated in place by 1-thread CUDA kernels (``Quaternion.cu:4-10``). Here a
pose is an immutable pytree ``(quat, translation)``; the rotation matrix is
recomputed on demand (a handful of FLOPs, fused by XLA) and poses flow through
``jit``/``grad`` like any other parameter — which is what makes camera/object
pose differentiable for free.

Quaternion layout is ``(x, y, z, w)`` = reference ``(i, j, k, w)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

from . import vecmath


def identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype)


def qmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a ⊗ b, matching the reference's quaternion multiply
    (vector.cpp:40-45 and vector.cuh quaternion_mul)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        (
            ay * bz - az * by + ax * bw + aw * bx,
            az * bx - ax * bz + ay * bw + aw * by,
            ax * by - ay * bx + az * bw + aw * bz,
            aw * bw - ax * bx - ay * by - az * bz,
        ),
        axis=-1,
    )


def qconj(q: jax.Array) -> jax.Array:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], q.dtype)


def qnormalize(q: jax.Array) -> jax.Array:
    return q * jax.lax.rsqrt(jnp.sum(q * q, axis=-1, keepdims=True))


def from_axis_angle(axis: jax.Array, angle: jax.Array,
                    dtype=jnp.float32) -> jax.Array:
    """Unit quaternion for a rotation of ``angle`` radians about ``axis``."""
    axis = vecmath.normalize(jnp.asarray(axis, dtype))
    half = jnp.asarray(angle, dtype) / 2.0
    return jnp.concatenate(
        [axis * jnp.sin(half)[..., None], jnp.cos(half)[..., None]], axis=-1
    )


def to_matrix(q: jax.Array) -> jax.Array:
    """3x3 rotation matrix of unit quaternion ``q``.

    Matches the (correct) quat->matrix form in vector.cpp:48-59; the
    reference's ``Quaternion::set_transformation_matrix_rot``
    (Quaternion.cpp:51-67) has a j/k index swap in the y row — a latent bug we
    deliberately do not reproduce (documented divergence, see SURVEY.md §2).
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        (
            1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
            2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
            2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
        ),
        axis=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors ``v`` (..., 3) by unit quaternion ``q`` (4,).

    precision=HIGHEST: a reduced-precision float32 matmul (TF32 on a GPU)
    would visibly bend ray directions; full f32 costs nothing at 3x3.
    """
    return jnp.einsum("ij,...j->...i", to_matrix(q), v,
                      precision=jax.lax.Precision.HIGHEST)


def inverse_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate by the conjugate — what the intersect kernel does to each ray
    to move it into the object's build-time frame (Trixel.cu:64-66)."""
    return jnp.einsum("ji,...j->...i", to_matrix(q), v,
                      precision=jax.lax.Precision.HIGHEST)


@pytree_dataclass
class Pose:
    """Rigid pose: rotation quaternion + translation.

    Replaces the reference's pose-in-matrix-w-column representation
    (Quaternion.cpp:45-50). ``translation`` maps object frame -> world.
    """

    quat: jax.Array  # (4,) unit (x, y, z, w)
    translation: jax.Array  # (3,)

    @classmethod
    def identity(cls, dtype=jnp.float32) -> "Pose":
        return cls(quat=identity(dtype), translation=jnp.zeros(3, dtype))

    def matrix(self) -> jax.Array:
        return to_matrix(self.quat)

    def apply(self, pts: jax.Array) -> jax.Array:
        """Object frame -> world: R p + t."""
        return rotate(self.quat, pts) + self.translation

    def apply_vec(self, v: jax.Array) -> jax.Array:
        """Rotate direction vectors (no translation)."""
        return rotate(self.quat, v)

    def inv_apply(self, pts: jax.Array) -> jax.Array:
        """World -> object frame: R^T (p - t)."""
        return inverse_rotate(self.quat, pts - self.translation)

    def inv_apply_vec(self, v: jax.Array) -> jax.Array:
        return inverse_rotate(self.quat, v)

    def translated(self, delta: jax.Array) -> "Pose":
        """Translate in world space. Analogue of the reference's O(1)
        translation update that only touches the matrix w column
        (Camera.cu:188-192,271-279) — geometry never moves."""
        return self.replace(translation=self.translation + delta)

    def rotated(self, dq: jax.Array, pivot: jax.Array | None = None) -> "Pose":
        """Compose rotation ``dq`` (about ``pivot`` in world space, default
        the pose origin). Mirrors ROTATE_TRI_±Y's recentering so rotation is
        about the object, not the camera (Camera.cu:288-329)."""
        new_q = qnormalize(qmul(self.quat, dq))
        if pivot is None:
            return self.replace(quat=new_q)
        # world-space pivot stays fixed: t' = pivot + (R' R^-1)(t - pivot)
        rel = self.translation - pivot
        spin = qmul(new_q, qconj(self.quat))
        return Pose(quat=new_q, translation=pivot + rotate(spin, rel))
