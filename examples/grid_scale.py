"""Scale demo: the grid_50x50 benchmark network (2,500 nodes / 9,800
directed links — the BASELINE 10k-link design point), run with the
windowed-history engine and batched replicas.

No reference counterpart (the reference's largest bundled network is
melbourne, 938 directed links; its grids are 7x7 via data/create_grid.py).

Run:  python examples/grid_scale.py [--batch 16] [--steps 100]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pednstream_tpu.engine import simulate_batched
from pednstream_tpu.generator import NetworkEnvGenerator
from pednstream_tpu.scenario import build_scenario


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    args = p.parse_args()

    gen = NetworkEnvGenerator()
    data = gen.load_network_data("grid_50x50")
    scn = build_scenario(
        data["adjacency_matrix"], gen.config["params"],
        gen.config["origin_nodes"], gen.config["destination_nodes"],
        history_window=64, binomial_mode="fast",
    )
    ep = scn.engine_params
    print(f"grid_50x50: {scn.n_nodes} nodes, {scn.n_links} directed links, "
          f"H={scn.H}")

    # lockstep rollout: scan outside, vmap inside, shared t (see
    # engine.simulate_batched — vmapping a whole per-replica scan makes
    # the ring-row writes scatter per replica, ~2x slower)
    run = jax.jit(lambda ss: simulate_batched(scn, ep, ss, args.steps,
                                              stochastic=True))
    states = jax.vmap(scn.init_state)(
        jax.random.split(jax.random.PRNGKey(0), args.batch))
    jax.block_until_ready(run(states))  # compile + warm

    states = jax.block_until_ready(jax.vmap(scn.init_state)(
        jax.random.split(jax.random.PRNGKey(1), args.batch)))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(states))
    dt = time.perf_counter() - t0
    total_peds = float(out.num_peds.sum())
    rate = args.steps * args.batch / dt
    print(f"{args.steps} steps x {args.batch} replicas in {dt:.2f}s "
          f"= {rate:,.0f} env-steps/s "
          f"({rate * scn.n_links / 1e9:.2f}e9 link-updates/s); "
          f"{total_peds:,.0f} pedestrians in network")


if __name__ == "__main__":
    main()
