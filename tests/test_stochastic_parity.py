"""Distributional parity of STOCHASTIC mode vs the reference.

Deterministic mode is bit-exact (test_golden_parity).  Stochastic mode
uses JAX PRNG instead of NumPy's global stream, so trajectories differ
sample-by-sample; this test checks the *distributions* match: total
arrivals and mean network density over N independent runs of the same
scenario, engine vs reference, within overlapping confidence bands.
"""

import os
import sys

import numpy as np
import pytest

import jax

REFERENCE = "/root/reference"

ADJ = np.array([
    [0, 1, 0, 0],
    [1, 0, 1, 0],
    [0, 1, 0, 1],
    [0, 0, 1, 0],
])
PARAMS = {
    "unit_time": 10, "simulation_steps": 150, "seed": None,
    "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6, "activity_probability": 0.1},
    "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
}
N_RUNS = 12


def _our_runs(binomial_mode="exact", prng_impl="threefry2x32"):
    import copy

    from pednstream_tpu import build_scenario
    from pednstream_tpu.engine import simulate

    arrivals, densities = [], []
    for i in range(N_RUNS):
        params = copy.deepcopy(PARAMS)
        params["seed"] = 1000 + i  # per-run demand seed
        scn = build_scenario(ADJ, params, [0], [3], binomial_mode=binomial_mode)
        f, outs = simulate(scn, scn.engine_params,
                           scn.init_state(jax.random.key(i, impl=prng_impl)),
                           PARAMS["simulation_steps"] - 1,
                           stochastic=True, record=True)
        arrivals.append(float(np.asarray(f.virt_arr_cum).sum()))
        densities.append(float(np.asarray(outs.density).mean()))
    return np.array(arrivals), np.array(densities)


def _ref_runs():
    sys.path.insert(0, REFERENCE)
    try:
        from src.LTM.network import Network

        arrivals, densities = [], []
        for i in range(N_RUNS):
            import copy

            params = copy.deepcopy(PARAMS)
            params["seed"] = 1000 + i
            np.random.seed(5000 + i)
            net = Network(ADJ, params, origin_nodes=[0], destination_nodes=[3],
                          verbose=False)
            for t in range(1, PARAMS["simulation_steps"]):
                net.network_loading(t)
            arr = sum(
                node.virtual_outgoing_link.cumulative_inflow[-2]
                for node in net.nodes.values()
                if node.virtual_outgoing_link is not None
            )
            arrivals.append(float(arr))
            densities.append(float(np.mean(
                [link.density[1:PARAMS["simulation_steps"]].mean()
                 for link in net.links.values()]
            )))
        return np.array(arrivals), np.array(densities)
    finally:
        sys.path.remove(REFERENCE)


@pytest.mark.skipif(not os.path.isdir(REFERENCE), reason="reference not mounted")
@pytest.mark.parametrize("binomial_mode,prng_impl", [
    # the exact-sampler variant costs ~40s alone (rejection sampling on
    # CPU); the two fast-path variants below pin the same distributional
    # claims on the shipped configuration, so exact rides the xslow tier
    pytest.param("exact", "threefry2x32", marks=pytest.mark.xslow),
    pytest.param("fast", "threefry2x32", marks=pytest.mark.slow),
    # unsafe_rbg draws its bits from XLA's RngBitGenerator op instead of
    # threefry; whether it is faster on the GPU is an open question.
    # "unsafe" refers to split/fold_in key-derivation rigor, not bit
    # quality; this case pins its distributional parity with the
    # reference.
    pytest.param("fast", "unsafe_rbg", marks=pytest.mark.slow),
])
def test_stochastic_distribution_parity(binomial_mode, prng_impl):
    ours_arr, ours_dens = _our_runs(binomial_mode, prng_impl)
    ref_arr, ref_dens = _ref_runs()

    # same demand seeds => identical demand; stochastic release/activity
    # draws differ but should produce overlapping distributions
    for mine, ref, name, rel_tol in [
        (ours_arr, ref_arr, "total arrivals", 0.15),
        (ours_dens, ref_dens, "mean density", 0.25),
    ]:
        m_mu, r_mu = mine.mean(), ref.mean()
        pooled_sd = np.sqrt((mine.std() ** 2 + ref.std() ** 2) / 2) + 1e-9
        rel = abs(m_mu - r_mu) / max(abs(r_mu), 1e-9)
        z = abs(m_mu - r_mu) / (pooled_sd * np.sqrt(2.0 / N_RUNS))
        assert rel < rel_tol or z < 4.0, (
            f"{name}: ours {m_mu:.2f}±{mine.std():.2f} vs "
            f"reference {r_mu:.2f}±{ref.std():.2f} (rel {rel:.3f}, z {z:.2f})"
        )
