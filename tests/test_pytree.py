"""The pytree dataclass helper that carries engine state and parameters."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pednstream_tpu.pytree import pytree_dataclass, static_field


@pytree_dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = static_field()


def test_replace_is_functional_and_instances_frozen():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(3), n=4)
    q = p.replace(a=jnp.full(2, 7.0))
    assert float(q.a[0]) == 7.0 and float(p.a[0]) == 0.0
    assert q.b is p.b and q.n == 4
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(2)


def test_flatten_unflatten_keeps_static_fields_out_of_leaves():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(3), n=4)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # n is metadata, not a leaf
    back = jax.tree_util.tree_unflatten(treedef, [x + 1 for x in leaves])
    assert back.n == 4 and float(back.a[0]) == 1.0
    # the static field is part of the structure
    other = jax.tree_util.tree_structure(p.replace(n=5))
    assert other != treedef


def test_transforms_map_over_data_fields():
    p = _Pair(a=jnp.arange(3.0), b=jnp.arange(4.0), n=2)
    out = jax.jit(lambda x: x.replace(a=x.a * x.n))(p)
    np.testing.assert_array_equal(np.asarray(out.a), [0.0, 2.0, 4.0])
    batched = jax.vmap(lambda x: x.a.sum())(
        _Pair(a=jnp.ones((5, 3)), b=jnp.ones((5, 4)), n=2))
    assert batched.shape == (5,)


def test_engine_state_is_a_registered_pytree():
    from pednstream_tpu.routing import RoutingTables
    from pednstream_tpu.state import NetworkState

    names = {f.name for f in dataclasses.fields(RoutingTables)
             if f.metadata.get("static")}
    assert names == {"num_groups", "num_uo_groups", "num_entries", "num_routed"}
    n = len(dataclasses.fields(NetworkState))
    st = NetworkState(*[jnp.zeros(1)] * n)
    assert len(jax.tree_util.tree_leaves(st)) == n
