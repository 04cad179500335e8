"""N-curve history reads: the single-pass forms agree with the
straightforward per-lag gathers."""

import numpy as np

import jax
import jax.numpy as jnp


def _data(E=64, H=50, seed=0):
    rng = np.random.default_rng(seed)
    # rings are time-major [H, E]; coefs [4, E]
    ring = jnp.asarray(rng.uniform(0, 40, (H, E)).astype(np.float32))
    base = jnp.asarray(rng.integers(-2, H, E).astype(np.int32))
    coefs = jnp.asarray(rng.uniform(0, 1, (4, E)).astype(np.float32))
    return ring, base, coefs


def _naive_diffusion(ring, base, coefs, H):
    E = ring.shape[1]
    out = np.zeros(E)
    for e in range(E):
        for k in range(4):
            i = int(base[e]) - k
            if i >= 0:
                out[e] += float(coefs[k, e]) * float(ring[i % H, e])
    return out


def test_diffusion_single_pass():
    from pednstream_tpu.ops import diffusion_single_pass

    ring, base, coefs, = _data()
    H = ring.shape[0]
    got = np.asarray(diffusion_single_pass(ring, base, coefs, H))
    want = _naive_diffusion(np.asarray(ring), np.asarray(base), np.asarray(coefs), H)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fast_vs_parity_diffusion_in_engine():
    """Full simulation: fast single-pass diffusion matches the parity
    4-read path to floating tolerance."""
    from pednstream_tpu import build_scenario
    from pednstream_tpu.engine import simulate

    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    params = {
        "unit_time": 10, "simulation_steps": 80, "seed": 1,
        "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6},
        "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
    }
    runs = {}
    for mode in [True, False]:
        scn = build_scenario(adj, params, [0], [3], exact_parity=mode)
        f, _ = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                        80, stochastic=False, record=False)
        runs[mode] = np.asarray(f.density)
    np.testing.assert_allclose(runs[True], runs[False], atol=5e-3)


def test_boundary_and_diffusion_reads():
    """One-pass cum-ring read == separate boundary read + inflow-ring
    diffusion, given inflow[s] = cum_in[s] - cum_in[s-1]."""
    from pednstream_tpu.ops import boundary_and_diffusion_reads, diffusion_single_pass

    rng = np.random.default_rng(3)
    E, H = 96, 24
    # integer-valued cumulative curve, nondecreasing over time
    infl = rng.integers(0, 20, (H, E)).astype(np.float32)
    cum = np.cumsum(infl, axis=0)
    cum_ring = jnp.asarray(cum)
    inflow_ring = jnp.asarray(np.concatenate(
        [cum[:1], cum[1:] - cum[:-1]], axis=0))
    base = jnp.asarray(rng.integers(-2, H, E).astype(np.int32))
    coefs = jnp.asarray(rng.uniform(0, 1, (4, E)).astype(np.float32))
    idx_ci = jnp.asarray(rng.integers(-1, H, E).astype(np.int32))

    ci, diff = boundary_and_diffusion_reads(cum_ring, idx_ci, base, coefs, H)
    want_diff = diffusion_single_pass(inflow_ring, base, coefs, H)
    np.testing.assert_allclose(np.asarray(diff), np.asarray(want_diff), rtol=1e-5)
    want_ci = np.where(
        np.asarray(idx_ci) >= 0,
        np.take_along_axis(cum, np.asarray(idx_ci)[None, :] % H, axis=0)[0],
        0.0,
    )
    np.testing.assert_allclose(np.asarray(ci), want_ci, rtol=1e-6)
