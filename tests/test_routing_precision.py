"""The fast routing path's one-hot matmul aggregation: it names its
precision (a GPU would otherwise run the float32 products in TF32) and
agrees with the exact path's segment_sum to float32 rounding."""

import re

import numpy as np

import jax
import jax.numpy as jnp

from pednstream_tpu.generator import NetworkEnvGenerator
from pednstream_tpu.routing import turning_fractions_step


def _args(dataset="45_intersections", seed=3):
    scn = NetworkEnvGenerator().create_network(dataset)
    rt, ep, f = scn.routing, scn.engine_params, scn.ftype
    rng = np.random.RandomState(seed)
    E = scn.n_links
    return (rt, scn.n_nodes, scn.max_deg, scn.node_arity, scn.slot_valid,
            jnp.asarray(rng.uniform(0, 8, E).astype(f)),
            jnp.asarray(rng.uniform(-1, 30, E).astype(f)),
            jnp.asarray(rng.uniform(1, 40, E).astype(f)),
            jnp.asarray(ep.od_table[:, 5]), ep.phi_base)


def test_matmul_aggregation_matches_segment_sum():
    args = _args()
    fast = np.asarray(turning_fractions_step(*args, exact=False, compact=False))
    exact = np.asarray(turning_fractions_step(*args, exact=True))
    np.testing.assert_allclose(fast, exact, rtol=2e-6, atol=1e-7)
    assert np.abs(fast - np.asarray(args[-1])).max() > 1e-3  # routing acted


def test_fast_path_dots_request_highest_precision():
    args = _args()
    text = jax.jit(
        lambda d, r, c, o: turning_fractions_step(
            *args[:5], d, r, c, o, args[-1], exact=False, compact=True)
    ).lower(*args[5:9]).as_text()
    dots = re.findall(r"stablehlo\.dot_general.*", text)
    assert len(dots) >= 4  # three segment sums + the compact phi scatter
    for line in dots:
        assert "HIGHEST" in line, line
