"""Scalar/precision configuration for the ray tracer.

The analogue of the reference's compile-time precision switch
(``TEST_Dungeonrun/typedefs.h:11-29``: ``PPP_TAG`` selects ``T_fp`` =
float/double) and its device epsilons
(``TEST_Dungeonrun/vector.cuh:10-13``). Instead of a preprocessor tag we use a
module-level default dtype plus per-call overrides; everything is traced by
XLA, so the dtype flows through jit without recompiling the Python.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# Reference: MOLLER_TRUMBORE_DEVICE_EPSILON / DEVICE_EPSILON_SINGLE = 1e-16
# (TEST_Dungeonrun/vector.cuh:10-13). 1e-16 is representable in float32
# (min normal ~1.2e-38), so the same literal works for both precisions.
MT_EPSILON = 1e-16
SLAB_EPSILON = 1e-16

# Reference: draw distance hardcoded to 400 in Camera.cpp:70 and as a kernel
# literal in Trixel.cu:47. Here it is a real config value (see RenderConfig);
# this is only the default.
DEFAULT_DRAW_DISTANCE = 400.0

# Reference: background BGRA fill color (240, 130, 0) set at Camera.cpp:72.
DEFAULT_BACKGROUND_RGB = (240, 130, 0)

DEFAULT_FLOAT = jnp.float32
DEFAULT_INT = jnp.int32


@dataclasses.dataclass(frozen=True)
class Precision:
    """Bundle of dtypes, the analogue of typedefs.h's T_fp/T_uint/T_int.

    Consumed by passing ``.fp`` as the ``dtype`` argument of
    ``Triangles.from_vertices`` / ``Camera.create`` /
    ``PhongParams.reference``; the scene/camera dtype then flows through
    the whole render path (tests/test_f64.py exercises F64 end-to-end).
    float64 additionally requires ``jax.config.update("jax_enable_x64",
    True)`` (or the enable_x64 context manager)."""

    fp: jnp.dtype = jnp.float32
    int_: jnp.dtype = jnp.int32
    uint: jnp.dtype = jnp.uint32

    @property
    def precision_shift(self) -> int:
        """Sign-bit shift for this float width (typedefs.h:14-29)."""
        return 31 if self.fp == jnp.float32 else 63


F32 = Precision()
F64 = Precision(fp=jnp.float64, int_=jnp.int64, uint=jnp.uint64)
