"""Immutable dataclass pytrees on `jax.tree_util.register_dataclass`.

    @pytree_dataclass
    class Camera:
        pos: jax.Array                          # a pytree leaf
        res_w: int = static_field(default=960)  # static metadata

Fields are leaves unless declared with `static_field`, which makes them
part of the tree structure (hashable, never traced). Instances are frozen;
`.replace(**changes)` returns a modified copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept as static tree metadata instead of a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Make `cls` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
