"""Profile the grid_50x50 batched step on the accelerator and aggregate
device op times from the Chrome trace.

Run:  nohup python scripts/profile_grid.py > /tmp/profile_grid.log 2>&1 &
"""

import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

H = int(os.environ.get("PROF_H", "32"))
B = int(os.environ.get("PROF_B", "128"))
IMPL = os.environ.get("PROF_IMPL", "threefry2x32")  # bench path: unsafe_rbg
NOIR = os.environ.get("PROF_NOIR", "0") == "1"  # bench path: track_inflow_ring=False
DATASET = os.environ.get("PROF_DATASET", "grid_50x50")
STEPS = 100
TRACE_DIR = f"/tmp/grid_trace_{DATASET}_H{H}_B{B}_{IMPL}{'_noir' if NOIR else ''}"


def main():
    import jax

    from pednstream_tpu.engine import simulate_batched
    from pednstream_tpu.generator import NetworkEnvGenerator
    from pednstream_tpu.scenario import build_scenario

    gen = NetworkEnvGenerator()
    data = gen.load_network_data(DATASET)
    scn = build_scenario(
        data["adjacency_matrix"], gen.config["params"],
        gen.config["origin_nodes"], gen.config["destination_nodes"],
        history_window=H, binomial_mode="fast",
        track_inflow_ring=not NOIR,
    )
    ep = scn.engine_params
    run = jax.jit(lambda ss: simulate_batched(scn, ep, ss, STEPS,
                                              stochastic=True))
    mk = lambda s: jax.vmap(scn.init_state)(
        jax.random.split(jax.random.key(s, impl=IMPL), B))
    _ = float(run(mk(0)).num_peds.sum())  # warm fence

    st = mk(1)
    np.asarray(st.density)
    t0 = time.time()
    out = run(st)
    _ = float(out.num_peds.sum())
    wall = time.time() - t0
    print(f"H={H} B={B}: {STEPS * B / wall:.0f} env-steps/s "
          f"({wall / STEPS * 1e3:.2f} ms/step)", flush=True)

    st = mk(2)
    np.asarray(st.density)
    with jax.profiler.trace(TRACE_DIR):
        out = run(st)
        _ = float(out.num_peds.sum())

    time.sleep(2)
    paths = glob.glob(f"{TRACE_DIR}/plugins/profile/*/*.trace.json.gz")
    if not paths:
        print("no trace found", flush=True)
        return
    with gzip.open(sorted(paths)[-1], "rt") as f:
        trace = json.load(f)
    agg = defaultdict(lambda: [0.0, 0])
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")
            agg[name][0] += ev["dur"]
            agg[name][1] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    print(f"top ops by total device time (us), count>={STEPS // 2}:")
    total = 0.0
    for name, (dur, cnt) in rows:
        if cnt >= STEPS // 2:
            total += dur
    for name, (dur, cnt) in rows[:40]:
        if cnt >= STEPS // 2:
            print(f"  {dur / STEPS:9.1f} us/step  x{cnt:<6} "
                  f"{100 * dur / total:5.1f}%  {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
