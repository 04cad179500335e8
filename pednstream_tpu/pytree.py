"""Frozen dataclasses that are JAX pytrees.

``@pytree_dataclass`` makes a frozen dataclass whose fields are pytree
children, except those declared with :func:`static_field`, which become
static metadata (part of the tree structure, hashed into jit cache keys).
Instances get ``.replace(**changes)`` for functional updates.
"""

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (static metadata)."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=True)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = _replace
    return cls
