"""Reference-trajectory fixtures and the comparison with them.

``tests/golden/*.npz`` hold trajectories of the reference implementation
with its binomial draws replaced by their expectation (generated by
``scripts/gen_golden.py`` and ``scripts/gen_golden_realworld.py``).  The
engine reproduces them in deterministic, exact-parity float64 mode; the
functions here rebuild a fixture's scenario exactly as the fixture was
made, run it, and return the max abs error per recorded field.  Callers
enable float64 (``jax.enable_x64``) first.
"""

import json
import os

import numpy as np

import jax
import jax.numpy as jnp

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "golden")

# BASELINE.json's parity target (the engine reaches it bit-exactly)
TOLERANCE = 1e-5
# fixtures of bundled datasets; every other fixture embeds its scenario
DATASET_FIXTURES = ("delft", "melbourne")

FIELDS = {
    # field -> (engine output attr, ref column offset relative to step t)
    "inflow": ("inflow", 0),
    "outflow": ("outflow", 0),
    "num_pedestrians": ("num_peds", 0),
    "density": ("density", 0),
    "speed": ("speed", 0),
    "travel_time": ("travel_time", 0),
    "cumulative_inflow": ("cum_in", 0),
    "cumulative_outflow": ("cum_out", 0),
    # sending/receiving are stored at index t-1 during step t
    # (node.py:178,206)
    "sending_flow": ("sending", -1),
    "receiving_flow": ("receiving", -1),
}


def _errors(scn, g, T):
    from .engine import simulate

    _, outs = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                       T - 1, stochastic=False, record=True)
    link_keys = [f"{u}_{v}" for (u, v) in scn.topo.link_nodes.tolist()]
    order = [link_keys.index(k) for k in list(g["link_keys"])]
    errs = {}
    for field, (attr, off) in FIELDS.items():
        if field not in g:
            continue
        mine = np.asarray(getattr(outs, attr))[:, order]  # row i = step i+1
        ref = (g[field][:, 0:T - 1] if off else g[field][:, 1:T]).T
        errs[field] = float(np.abs(mine - ref).max())
    return errs


def scenario_fixture_errors(name: str):
    """A fixture that embeds its scenario (adjacency, params, OD sets)."""
    from .scenario import build_scenario

    g = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"), allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    params = meta["params"]
    od_flows = {
        tuple(map(int, k.split("_"))): v for k, v in meta.get("od_flows", {}).items()
    } or None
    np.random.seed(params.get("seed", 42))
    scn = build_scenario(
        np.array(meta["adj"]), params,
        origin_nodes=meta["origins"],
        destination_nodes=meta.get("dests") or [],
        od_flows=od_flows, ftype=jnp.float64, exact_parity=True,
    )
    return _errors(scn, g, params["simulation_steps"])


def dataset_fixture_errors(dataset: str):
    """A fixture of a bundled dataset (delft, melbourne), run over the
    fixture's step count."""
    from .generator import NetworkEnvGenerator

    g = np.load(os.path.join(GOLDEN_DIR, f"{dataset}.npz"), allow_pickle=True)
    np.random.seed(42)
    gen = NetworkEnvGenerator(ftype=jnp.float64, exact_parity=True)
    scn = gen.create_network(dataset)
    return _errors(scn, g, json.loads(str(g["meta"]))["steps"])


def fixture_names():
    return sorted(f[:-4] for f in os.listdir(GOLDEN_DIR) if f.endswith(".npz"))


def fixture_errors(name: str):
    if name in DATASET_FIXTURES:
        return dataset_fixture_errors(name)
    return scenario_fixture_errors(name)
