"""Link-axis state sharding demo (SURVEY §2.6's TP analog): one network
too large for a single chip's ring budget, its simulation state blocked
over every available device.

Builds an n x n 4-neighbour grid (default 165 -> 108,240 directed
links), shards the O(E*H) ring state over a 1-D 'link' mesh via
parallel/link_shard.py, runs a few hundred steps, and reports per-chip
shard shapes + throughput.  With --hybrid it instead runs a BATCH of
replicas on a 2-D env x link mesh (the pod layout: DP over the slow
axis, state sharding over the fast axis).

No reference counterpart: the reference is a single-process object
graph (largest bundled network: melbourne, 938 directed links).

Without several devices, pass --cpu-mesh 8 for a virtual 8-device CPU
mesh (the flag sets the platform programmatically, before JAX starts):
  python examples/link_sharded_scale.py --n 60 --steps 100 --cpu-mesh 8
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --cpu-mesh must take effect before the first jax import
_CPU_MESH = 0
for _i, _a in enumerate(sys.argv):
    if _a.startswith("--cpu-mesh="):  # '--cpu-mesh=8' form
        _CPU_MESH = int(_a.split("=", 1)[1])
    elif _a == "--cpu-mesh":  # '--cpu-mesh 8' form
        if _i + 1 >= len(sys.argv):
            sys.exit("--cpu-mesh needs a device count (e.g. --cpu-mesh 8)")
        _CPU_MESH = int(sys.argv[_i + 1])
if _CPU_MESH:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={_CPU_MESH}")

import numpy as np

import jax

if _CPU_MESH:
    jax.config.update("jax_platforms", "cpu")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=165,
                   help="grid side; directed links = 4*n*(n-1)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--hybrid", action="store_true",
                   help="batch of replicas on a 2-D env x link mesh")
    p.add_argument("--batch", type=int, default=4, help="replicas (hybrid)")
    p.add_argument("--cpu-mesh", type=int, default=0, metavar="N",
                   help="force an N-device virtual CPU mesh (must be set "
                        "before the first jax use)")
    args = p.parse_args()

    ndev = len(jax.devices())
    if ndev < 2 or (args.hybrid and ndev % 2):
        p.error(f"{ndev} device(s) visible — sharding needs a mesh; "
                "pass --cpu-mesh 8 for a virtual one")

    from pednstream_tpu.config import grid_adjacency
    from pednstream_tpu.scenario import build_scenario

    n, N = args.n, args.n * args.n
    adj = grid_adjacency(n, n)
    params = {
        "simulation_steps": args.steps + 1,
        "unit_time": 10,
        "seed": 0,
        "default_link": {
            "length": 80, "width": 3, "free_flow_speed": 1.2,
            "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
        },
        "demand": {
            "origin_0": {"pattern": "constant", "base_lambda": 8},
            f"origin_{N - 1}": {"pattern": "constant", "base_lambda": 8},
        },
    }
    t0 = time.time()
    scn = build_scenario(adj, params, [0, N - 1], [n - 1, N - n],
                         history_window=args.window)
    E, H = scn.n_links, scn.H
    ndev = len(jax.devices())
    print(f"built {N} nodes / {E} directed links in {time.time()-t0:.1f}s; "
          f"ring state = {4 * E * H * 4 / 1e6:.0f} MB over {ndev} devices")

    if args.hybrid:
        from pednstream_tpu.parallel import (
            make_hybrid_sharded_simulate, make_mesh_2d, shard_hybrid_state,
        )

        mesh = make_mesh_2d(2, ndev // 2)
        states = jax.vmap(scn.init_state)(
            jax.random.split(jax.random.PRNGKey(0), args.batch))
        run = make_hybrid_sharded_simulate(scn, mesh, args.steps,
                                           stochastic=True)
        t0 = time.time()
        out = run(scn.engine_params, shard_hybrid_state(states, mesh))
        mass = float(np.asarray(out.num_peds).sum())
        dt = time.time() - t0
        shard = out.cum_in_ring.addressable_shards[0].data.shape
        print(f"hybrid {mesh.shape}: {args.batch} replicas x {args.steps} "
              f"steps in {dt:.1f}s (compile-inclusive), per-chip ring shard "
              f"{shard}, final in-network mass {mass:.0f}")
    else:
        from pednstream_tpu.parallel import (
            make_link_sharded_simulate, make_mesh, shard_link_state,
        )

        mesh = make_mesh(axis="link")
        run = make_link_sharded_simulate(scn, mesh, args.steps,
                                         stochastic=True)
        st = shard_link_state(scn.init_state(jax.random.PRNGKey(0)), mesh)
        t0 = time.time()
        out = run(scn.engine_params, st)
        mass = float(np.asarray(out.num_peds).sum())
        dt = time.time() - t0
        shard = out.cum_in_ring.addressable_shards[0].data.shape
        print(f"link-sharded: {args.steps} steps in {dt:.1f}s "
              f"(compile-inclusive), per-chip ring shard {shard} "
              f"(= H x E/{ndev}), final in-network mass {mass:.0f}")


if __name__ == "__main__":
    main()
