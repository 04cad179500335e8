"""End-to-end smoke run of the main path on NVIDIA GPUs.

    python chip_smoke.py          # phases 0-5 on one card
    python chip_smoke.py --multi  # the four-card paths (a)-(c), nothing else

Phases (one card):
  0 environment: device, versions, XLA_FLAGS, card name and power limit,
    which optional packages import
  1 reference parity: every golden fixture (tests/golden) in
    exact-parity float64 mode, every field within 1e-5
  2 batched Monte Carlo rollout: melbourne, 1,024 replicas, 16-step
    window, 500 steps, built as bench.py builds it; exact mass
    conservation, and the final state of 32 of the replicas equal to the
    same program run on this process's CPU device: counts bitwise,
    speeds and travel times within 1e-5 relative
  3 one replica with exact full-horizon history (H = T+1 = 501)
  4 the batched RL env: butterfly_scC, 4,096 replicas, reset + 5 steps
  5 the interactive service: mcp.server create/run/status on melbourne

Four cards (--multi), each compared with the same program on one card:
  a melbourne, 1,024 replicas sharded over an ``env`` mesh of 4
  b grid_50x50 (E = 9,800), deterministic, link axis sharded over 4
  c grid_50x50, the hybrid 2 (env) x 2 (link) mesh

One process holds the card(s) and starts no child that uses JAX.  Each
phase prints JSON lines; any failure raises, and the script then exits
non-zero without a result line.  The card lines print as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does.
The last line is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import importlib
import json
import os
import statistics
import sys
import time

import numpy as np

# the CPU reference of phase 2 needs JAX's CPU backend next to the GPU
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402

import bench  # noqa: E402
from pednstream_tpu.utils.gpu import (card_lines, configure_compile_cache,  # noqa: E402
                                      require_gpu)

MELBOURNE_BATCH = 1024
CPU_BATCH = 32
ENV_BATCH = 4096
TIMED_RUNS = 5
# Phase 2 compares these fields within a relative bound, every other field
# bitwise.  A few ulp of rounding is ~1e-7 relative; a pedestrian more or
# less on a link moves speeds by far more than the bound.
CONTINUOUS_FIELDS = ("speed", "travel_time", "link_flow", "avg_tt", "tt_run_sum",
                     "tt_ring")
CONTINUOUS_MAX_REL_DIFF = 1e-5


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def result_line(devices) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def check_mass(st, what: str):
    """Exact conservation on every link: cum_in - cum_out == num_peds,
    with integer flows (stochastic mode), and an all-finite state."""
    st = _np(st)
    for name, x in vars(st).items():
        if np.issubdtype(x.dtype, np.floating) and not np.isfinite(x).all():
            raise AssertionError(f"{what}: non-finite {name}")
    if not np.array_equal(st.cum_in - st.cum_out, st.num_peds):
        raise AssertionError(f"{what}: cum_in - cum_out != num_peds")
    if not np.array_equal(st.cum_in, np.round(st.cum_in)):
        raise AssertionError(f"{what}: non-integer cumulative inflow")


def phase_env(devices):
    packages = {}
    for name in ("flax", "yaml", "networkx", "pettingzoo", "gymnasium"):
        try:
            importlib.import_module(name)
            packages[name] = True
        except ImportError:
            packages[name] = False
    import jaxlib

    log("env", device_kind=devices[0].device_kind, device_count=len(devices),
        jax=jax.__version__, jaxlib=jaxlib.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""), packages=packages,
        compile_cache=configure_compile_cache())


def phase_parity():
    from pednstream_tpu.golden import TOLERANCE, fixture_errors, fixture_names

    # float64 for this phase only, set globally: the host callback of the
    # LP-allocation fixture (optimal_diamond) runs on a thread that a
    # scoped jax.enable_x64 does not reach
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for fixture in fixture_names():
            t0 = time.perf_counter()
            errs = fixture_errors(fixture)
            log("parity", fixture=fixture, max_abs_err=errs, tolerance=TOLERANCE,
                bit_exact=max(errs.values()) == 0.0,
                seconds=time.perf_counter() - t0)
            bad = {k: v for k, v in errs.items() if not v <= TOLERANCE}
            if bad:
                raise AssertionError(f"{fixture} misses {TOLERANCE}: {bad}")
    finally:
        jax.config.update("jax_enable_x64", x64)


def phase_batched(batch=MELBOURNE_BATCH, cpu_batch=CPU_BATCH,
                  steps=bench.STEPS, runs=TIMED_RUNS):
    scn = bench.dataset_scenario("melbourne")
    run = bench.batched_rollout(scn, steps)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    states = jax.vmap(scn.init_state)(keys)
    compiled, compile_s = bench.compile_timed(run, states)
    out = _np(compiled(states))
    check_mass(out, "batched rollout")
    times, _ = bench.time_runs(
        compiled, lambda s: bench.batched_states(scn, s, batch), runs)
    med = statistics.median(times)
    log("batched", dataset="melbourne", batch=batch, steps=steps,
        history_window=scn.H, compile_s=compile_s, run_s=times, median_s=med,
        env_steps_per_s=steps * batch / med,
        peak_bytes_in_use=bench.peak_bytes(), card=card_lines()[0])

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref_states = jax.vmap(scn.init_state)(jax.device_put(keys[:cpu_batch], cpu))
        # capped at AVX2: the persistent cache may hand back a CPU
        # executable built on a host with more CPU features than this one
        ref = _np(run.lower(ref_states).compile(
            compiler_options={"xla_cpu_max_isa": "AVX2"})(ref_states))
    # Both runs draw the same threefry bits and every float32 quotient is
    # correctly rounded (ops/division.py), so every pedestrian count,
    # cumulative curve and density agrees bitwise.  The speed/travel-time
    # fields may differ by a few ulp: the fast path lets the compiler fuse
    # a*b+c into an FMA, and the GPU's exp/sqrt/pow may round differently.
    mine = jax.tree_util.tree_map(lambda x: x[:cpu_batch], out)
    rel = {name: float(np.max(np.abs(getattr(mine, name) - getattr(ref, name))
                              / np.maximum(np.abs(getattr(ref, name)), 1e-30)))
           for name in CONTINUOUS_FIELDS}
    differing = [name for name in vars(ref) if name not in CONTINUOUS_FIELDS
                 and not np.array_equal(getattr(mine, name), getattr(ref, name))]
    log("batched_vs_cpu", replicas=cpu_batch,
        arrivals_gpu=mine.virt_arr_cum.sum(), arrivals_cpu=ref.virt_arr_cum.sum(),
        differing_fields=differing, continuous_max_rel_diff=rel,
        continuous_bound=CONTINUOUS_MAX_REL_DIFF)
    if differing:
        raise AssertionError(f"GPU rollout differs from the CPU run in {differing}")
    if max(rel.values()) > CONTINUOUS_MAX_REL_DIFF:
        raise AssertionError(f"GPU speeds/travel times depart from the CPU run: {rel}")


def phase_exact_single():
    from pednstream_tpu.engine import simulate

    scn = bench.dataset_scenario("melbourne", history_window=None,
                                 binomial_mode="exact")
    T = scn.simulation_steps
    run = jax.jit(lambda st: simulate(scn, scn.engine_params, st, T - 1,
                                      stochastic=True, record=False)[0])
    compiled, compile_s = bench.compile_timed(run, scn.init_state(jax.random.PRNGKey(0)))
    times, out = bench.time_runs(
        compiled, lambda s: scn.init_state(jax.random.PRNGKey(s)), TIMED_RUNS)
    check_mass(out, "exact single replica")
    log("exact_single", history_window=scn.H, steps=T - 1, compile_s=compile_s,
        run_s=times, steps_per_s=(T - 1) / statistics.median(times))


def random_actions(spec, batch, rng):
    actions = {}
    if spec.sep_ids:
        total = np.asarray(spec.sep_total_width, np.float32)
        actions["sep"] = rng.uniform(spec.min_sep_width, total - spec.min_sep_width,
                                     (batch, len(total))).astype(np.float32)
    for gid, widths in zip(spec.gate_ids, spec.gate_link_widths):
        w = np.asarray(widths, np.float32)
        actions[gid] = rng.uniform(0.0, w, (batch, len(w))).astype(np.float32)
    return actions


def phase_env_batch(batch=ENV_BATCH, steps=5):
    from pednstream_tpu.env import PedNetEnvCore, build_agent_spec
    from pednstream_tpu.generator import NetworkEnvGenerator

    scn = NetworkEnvGenerator().create_network("butterfly_scC")
    spec = build_agent_spec(scn)
    core = PedNetEnvCore(scn, spec, stochastic=True)
    states, obs = core.batch_reset(jax.random.split(jax.random.PRNGKey(7), batch))
    rng = np.random.default_rng(0)
    times = []
    for _ in range(steps):
        actions = random_actions(spec, batch, rng)
        t0 = time.perf_counter()
        states, obs, rewards, done = jax.block_until_ready(
            core.batch_step(states, actions))
        times.append(time.perf_counter() - t0)
    for agent in spec.agent_ids:
        o, r = np.asarray(obs[agent]), np.asarray(rewards[agent])
        if o.shape[0] != batch or r.shape != (batch,):
            raise AssertionError(f"{agent}: obs {o.shape}, reward {r.shape}")
        if not (np.isfinite(o).all() and np.isfinite(r).all()):
            raise AssertionError(f"{agent}: non-finite obs or reward")
    if not (np.asarray(states.t) == steps + 1).all():
        raise AssertionError("env replicas left lockstep")
    log("env_batch", dataset="butterfly_scC", batch=batch, agents=spec.agent_ids,
        obs_shapes={a: list(np.shape(obs[a])) for a in spec.agent_ids},
        step_s=times)


def phase_service(chunk=50):
    from pednstream_tpu.mcp import server

    created = server.create_environment("melbourne")
    if "error" in created:
        raise AssertionError(f"create_environment: {created['error']}")
    sim_id = created["sim_id"]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = server.run_simulation(sim_id, steps=chunk)
        times.append(time.perf_counter() - t0)
        if "error" in r:
            raise AssertionError(f"run_simulation: {r['error']}")
    status = server.get_status(sim_id)
    st = server._manager.get(sim_id).engine_state
    if status["current_step"] != 2 * chunk or int(st.t) != 2 * chunk + 1:
        raise AssertionError(f"service stepped to {status['current_step']}, t={int(st.t)}")
    check_mass(st, "service")
    log("service", dataset="melbourne", steps=2 * chunk, chunk_s=times,
        status=status["status"])


def _same(a, b, what) -> bool:
    """Log how far two states differ; True when bitwise equal."""
    a, b = _np(a), _np(b)
    leaves = [(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                     jax.tree_util.tree_leaves(b))]
    worst = max(float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)),
                             initial=0.0)) for x, y in leaves)
    log(what, max_abs_diff=worst,
        identical_link_share=float((a.cum_in == b.cum_in).mean()))
    return worst == 0.0


def phase_multi(devices, batch=MELBOURNE_BATCH, rollout_steps=bench.STEPS,
                grid_steps=200):
    from pednstream_tpu.engine import simulate, simulate_batched
    from pednstream_tpu.generator import NetworkEnvGenerator
    from pednstream_tpu.parallel import (make_hybrid_sharded_simulate,
                                         make_link_sharded_simulate, make_mesh,
                                         make_mesh_2d, shard_batch,
                                         shard_hybrid_state, shard_link_state)
    from pednstream_tpu.parallel.link_shard import assert_no_full_ring_collectives

    if len(devices) != 4:
        raise SystemExit(f"--multi needs 4 GPUs, found {len(devices)}")
    same = []

    # (a) replica-sharded batched rollout
    scn = bench.dataset_scenario("melbourne")
    run = bench.batched_rollout(scn, rollout_steps)
    mesh = make_mesh(4)
    one_c, one_compile = bench.compile_timed(run, bench.batched_states(scn, 0, batch))
    four_c, four_compile = bench.compile_timed(
        run, shard_batch(bench.batched_states(scn, 0, batch), mesh))
    one_s, one = bench.time_runs(one_c, lambda s: bench.batched_states(scn, s, batch),
                                 TIMED_RUNS)
    four_s, four = bench.time_runs(
        four_c, lambda s: shard_batch(bench.batched_states(scn, s, batch), mesh),
        TIMED_RUNS)
    log("multi_env", batch=batch, steps=rollout_steps,
        compile_s={"one_card": one_compile, "four_cards": four_compile},
        run_s={"one_card": one_s, "four_cards": four_s},
        env_steps_per_s={"one_card": rollout_steps * batch / statistics.median(one_s),
                         "four_cards": rollout_steps * batch / statistics.median(four_s)})
    same.append(_same(one, four, "multi_env_vs_one_card"))

    # (b) link-sharded grid_50x50, deterministic
    grid = NetworkEnvGenerator().create_network("grid_50x50")
    ep = grid.engine_params
    st = grid.init_state(jax.random.PRNGKey(0))
    ref = jax.jit(lambda e, s: simulate(grid, e, s, grid_steps, stochastic=False,
                                        record=False)[0])(ep, st)
    mesh = make_mesh(4, axis="link")
    st_sh = shard_link_state(st, mesh)
    compiled = make_link_sharded_simulate(grid, mesh, grid_steps).lower(ep, st_sh).compile()
    ring_bytes = grid.H * grid.n_links * np.dtype(st.cum_in_ring.dtype).itemsize
    n_coll, _ = assert_no_full_ring_collectives(compiled, ring_bytes)
    mem = compiled.memory_analysis()
    log("multi_link_compiled", links=grid.n_links, history_window=grid.H,
        steps=grid_steps, collectives=n_coll, full_ring_bytes=ring_bytes,
        per_device_memory={k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")})
    same.append(_same(ref, compiled(ep, st_sh), "multi_link_vs_one_card"))

    # (c) hybrid env x link, against the one-card batched run
    mesh2d = make_mesh_2d(2, 2)
    hyb_states = jax.vmap(grid.init_state)(jax.random.split(jax.random.PRNGKey(0), 4))
    ref_b = jax.jit(lambda e, s: simulate_batched(grid, e, s, grid_steps))(ep, hyb_states)
    out_h = make_hybrid_sharded_simulate(grid, mesh2d, grid_steps)(
        ep, shard_hybrid_state(hyb_states, mesh2d))
    same.append(_same(ref_b, out_h, "multi_hybrid_vs_one_card"))
    log("multi_hybrid_vs_link_reference", max_abs_density_diff=float(np.max(np.abs(
        np.asarray(out_h.density[0]) - np.asarray(ref.density)))))
    if not all(same):
        raise AssertionError("a sharded run differs from its one-card reference")


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--multi", action="store_true",
                      help="run only the four-card paths")
    multi = args.parse_args(argv).multi

    devices = jax.devices()
    require_gpu(devices)
    for line in card_lines():
        print(line, flush=True)
    phase_env(devices)
    if multi:
        phase_multi(devices)
    else:
        phase_parity()
        phase_batched()
        phase_exact_single()
        phase_env_batch()
        phase_service()
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    sys.exit(main())
