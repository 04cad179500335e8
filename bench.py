"""Engine throughput on one GPU.

Rows, one JSON line each, printed as each completes:
  melbourne        341 nodes / 938 directed links, BATCH stochastic
                   replicas in lockstep, WINDOW-step history ring, the
                   scenario's full 500-step horizon per run
  grid_50x50       9,800 directed links, 256 replicas, same settings
  melbourne_b4096  the melbourne row at 4,096 replicas
  single_replica   melbourne, one replica, exact full-horizon history

Every row carries the device as JAX reports it (platform, device_kind,
device count), the card's name and power limit, the compile seconds,
the seconds of each of TIMED_RUNS timed runs (fresh PRNG keys each), the
rate at the median run, and the process's peak device memory so far.
The last line is one JSON object with the headline figure:
  {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N, ...}

Baseline: the reference implementation (WaimenMak/PedNStream, pure
Python/NumPy, single process, no batched mode) on a CPU with the same
scenario: 21.05 steps/s (BASELINE.md).

Exits non-zero when JAX finds no GPU or when any row fails.  The
persistent compile cache lives where JAX_COMPILATION_CACHE_DIR points,
else in <checkout>/.jax_cache.

    python bench.py
"""

import json
import statistics
import time

import jax

REFERENCE_MELBOURNE_STEPS_PER_S = 21.05  # BASELINE.md
BATCH = 1024
WINDOW = 16
STEPS = 500  # one complete simulation (the scenarios' horizon) per run
TIMED_RUNS = 5


def emit(row: str, **kv):
    print(json.dumps({"row": row, **kv}), flush=True)


def dataset_scenario(name: str, history_window=WINDOW, binomial_mode="fast"):
    """A bundled dataset built as the benchmark rows build it.  The
    inflow ring is not maintained: the stochastic fast path never reads
    it in-loop (only host-side consumers such as the MPC baseline do)."""
    from pednstream_tpu.generator import NetworkEnvGenerator
    from pednstream_tpu.scenario import build_scenario

    gen = NetworkEnvGenerator()
    data = gen.load_network_data(name)
    return build_scenario(
        data["adjacency_matrix"], gen.config["params"],
        gen.config["origin_nodes"], gen.config["destination_nodes"],
        history_window=history_window, binomial_mode=binomial_mode,
        track_inflow_ring=False,
    )


def batched_states(scn, seed: int, batch: int):
    return jax.vmap(scn.init_state)(
        jax.random.split(jax.random.PRNGKey(seed), batch))


def batched_rollout(scn, steps: int = STEPS):
    """Jitted ``states -> final states`` over ``steps`` lockstep steps."""
    from pednstream_tpu.engine import simulate_batched

    return jax.jit(lambda ss: simulate_batched(scn, scn.engine_params, ss,
                                               steps, stochastic=True))


def compile_timed(fn, *args):
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def time_runs(compiled, make_input, n: int):
    """Seconds of ``n`` runs, each on a fresh input made before its
    clock starts, each ended by ``block_until_ready``."""
    times, out = [], None
    for i in range(n):
        x = jax.block_until_ready(make_input(i + 1))
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(x))
        times.append(time.perf_counter() - t0)
    return times, out


def peak_bytes():
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def bench_batched(row: str, dataset: str, batch: int, device: dict) -> float:
    scn = dataset_scenario(dataset)
    compiled, compile_s = compile_timed(batched_rollout(scn),
                                        batched_states(scn, 0, batch))
    times, out = time_runs(compiled, lambda s: batched_states(scn, s, batch),
                           TIMED_RUNS)
    assert float(out.num_peds.sum()) > 0, "engine produced an empty network"
    rate = STEPS * batch / statistics.median(times)
    emit(row, env_steps_per_s=rate, batch=batch, history_window=WINDOW,
         links=scn.n_links, compile_s=compile_s, run_s=times,
         peak_bytes_in_use=peak_bytes(), **device)
    return rate


def bench_single(device: dict) -> float:
    from pednstream_tpu.engine import simulate

    scn = dataset_scenario("melbourne", history_window=None,
                           binomial_mode="exact")
    T = scn.simulation_steps
    run = jax.jit(lambda st: simulate(scn, scn.engine_params, st, T - 1,
                                      stochastic=True, record=False)[0])
    compiled, compile_s = compile_timed(run, scn.init_state(jax.random.PRNGKey(0)))
    times, out = time_runs(compiled,
                           lambda s: scn.init_state(jax.random.PRNGKey(s)),
                           TIMED_RUNS)
    assert float(out.num_peds.sum()) > 0, "engine produced an empty network"
    rate = (T - 1) / statistics.median(times)
    emit("single_replica", steps_per_s=rate, history_window=scn.H,
         compile_s=compile_s, run_s=times, peak_bytes_in_use=peak_bytes(),
         **device)
    return rate


def main():
    from pednstream_tpu.utils.gpu import (card_lines, configure_compile_cache,
                                          require_gpu)

    devices = jax.devices()
    require_gpu(devices)
    device = {"platform": devices[0].platform,
              "device_kind": devices[0].device_kind,
              "device_count": len(devices),
              "card": card_lines()[0]}
    emit("setup", compile_cache=configure_compile_cache(), **device)

    agg = bench_batched("melbourne", "melbourne", BATCH, device)
    grid = bench_batched("grid_50x50", "grid_50x50", 256, device)
    b4096 = bench_batched("melbourne_b4096", "melbourne", 4096, device)
    single = bench_single(device)

    print(json.dumps({
        "metric": (f"melbourne aggregate LTM env-steps/s, {BATCH} vmapped "
                   "stochastic replicas (938 links, hybrid binomial sampler) "
                   "on 1 GPU; baseline = reference single-process CPU steps/s"),
        "value": agg,
        "unit": "env-steps/s",
        "vs_baseline": agg / REFERENCE_MELBOURNE_STEPS_PER_S,
        "extra": {
            "grid_50x50_env_steps_per_s": grid,
            "melbourne_b4096_env_steps_per_s": b4096,
            "single_replica_melbourne_steps_per_s": single,
            **device,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
