"""Golden-trajectory parity: the JAX engine must reproduce the reference
implementation's trajectories (deterministic mode: binomial -> expectation)
on bundled scenarios.

Fixtures under tests/golden/*.npz are produced by scripts/gen_golden.py,
which RUNS the reference with np.random.binomial patched to
floor(n)*p.  The target in BASELINE.json is densities matching
to 1e-5; the engine's dtype staging actually achieves bit-exactness on
these scenarios.
"""

import os

import numpy as np
import pytest

import jax

from pednstream_tpu.golden import (DATASET_FIXTURES, GOLDEN_DIR, TOLERANCE,
                                   dataset_fixture_errors, fixture_names,
                                   scenario_fixture_errors)


def _available():
    if not os.path.isdir(GOLDEN_DIR):
        return []
    return [f for f in fixture_names() if f not in DATASET_FIXTURES]


@pytest.mark.parametrize("name", _available() or ["long_corridor"])
def test_golden_parity(name, x64):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden fixture {name} missing; run scripts/gen_golden.py")
    # BASELINE.json parity target (achieved: bit-exact)
    for field, err in scenario_fixture_errors(name).items():
        assert err <= TOLERANCE, f"{name}.{field}: max abs err {err}"


@pytest.mark.slow
@pytest.mark.parametrize("dataset", ["delft", "melbourne"])
def test_golden_parity_realworld(dataset, x64):
    """Real-world networks (measured corridor lengths from
    edge_distances.pkl; melbourne adds activity_probability=0.5):
    bit-exact vs the reference over 199 steps."""
    path = os.path.join(GOLDEN_DIR, f"{dataset}.npz")
    if not os.path.exists(path):
        pytest.skip(f"{dataset} fixture missing; run scripts/gen_golden_realworld.py")
    for field, err in dataset_fixture_errors(dataset).items():
        assert err <= TOLERANCE, f"{dataset}.{field}: max abs err {err}"


def test_windowed_mode_semantics_jam_heavy(x64):
    """Windowed-history approximation error, quantified on a scenario
    engineered to exceed the window:
    400 m links give tau_shockwave = 73 and pulsed demand drives the
    dynamic avg-tt tau to ~76, so both lookbacks clamp under H=32 and
    H=64.  The exact full-horizon run is the reference semantics (the
    golden tests above pin it bit-exactly to the reference); windowed
    runs must stay stable and within documented bounds:

      H=64 (the shipped RL/bench config): identical total arrivals,
        mean |density error| < 0.05 ped/m^2;
      H=32 (window << tau_shockwave): degrades — receiving flows relax
        too early once the shockwave lookback clamps — but remains
        bounded and mass-conserving (documented in docs/PARITY.md).
    """
    import jax.numpy as jnp
    from pednstream_tpu import build_scenario
    from pednstream_tpu.engine import simulate

    adj = np.zeros((5, 5), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 4)]:
        adj[a, b] = adj[b, a] = 1
    params = {
        "simulation_steps": 400, "unit_time": 10, "seed": 5,
        "default_link": {"length": 400, "width": 4, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6, "gamma": 0.01},
        "links": {"3_4": {"width": 1.0}, "4_3": {"width": 1.0}},
        "demand": {"origin_0": {"pattern": "gaussian_peaks",
                                "peak_lambda": 60, "base_lambda": 5}},
    }
    T = params["simulation_steps"]
    runs = {}
    for label, kw in [("exact", {}), ("win32", {"history_window": 32}),
                      ("win64", {"history_window": 64})]:
        scn = build_scenario(adj, params, [0], [4], **kw)
        f, outs = simulate(scn, scn.engine_params,
                           scn.init_state(jax.random.PRNGKey(0)), T - 1,
                           stochastic=False, record=True)
        runs[label] = (f, outs, scn)

    f0, o0, s0 = runs["exact"]
    # the scenario genuinely exceeds the windows
    assert int(s0.tau_shockwave.max()) == 73
    assert float(np.asarray(f0.avg_tt).max()) / 10 > 64

    arr0 = float(np.asarray(f0.virt_arr_cum).sum())
    d0 = np.asarray(o0.density)
    for label, dens_bound, arr_bound in [("win64", 0.05, 0.005),
                                         ("win32", 0.20, 0.25)]:
        f, o, scn = runs[label]
        d = np.asarray(o.density)
        # stability: finite, non-negative, mass-conserving
        assert np.isfinite(d).all() and (d >= 0).all()
        np.testing.assert_allclose(
            np.asarray(f.cum_in) - np.asarray(f.cum_out),
            np.asarray(f.num_peds), atol=1e-9)
        mean_err = np.abs(d - d0).mean()
        arr = float(np.asarray(f.virt_arr_cum).sum())
        assert mean_err < dens_bound, (label, mean_err)
        assert abs(arr - arr0) / arr0 < arr_bound, (label, arr)
