"""Controlled ablation: delay-aligned global reward term / GAE horizon.

Two questions about the PPO controllers, one harness:

  * does a small shared ``-coef * total in-network count`` term in the
    TRAINING reward (env/core.py global_reward_coef; evaluation rewards
    are untouched) let PPO close the total-delay gap (to the MPC
    baseline on metered_corridor, to SAC on two_coordinators)?
  * is the missing gridlock-prevention behavior a GAE-horizon problem
    instead (``--rollout-len`` sweep)?

Each candidate trains the SAME BatchedPPOTrainer configuration the zoo
uses (scripts/train_zoo.py train_ppo), exports to
outputs/ablate_<dataset>/<tag>/, and is scored under the identical
paired 3-run protocol (rl.evaluate.evaluate_agents) on the TRUE reward
and the offline metrics.  Results print as one JSON line per candidate.

Run:  python scripts/ablate_global_reward.py --dataset metered_corridor \
          --coefs 0.0 0.1 0.3
      python scripts/ablate_global_reward.py --dataset two_coordinators \
          --coefs 0.0 --rollout-lens 16 64
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from train_zoo import DATASETS, OD_RANDOMIZE, _export_ppo, _max_delta  # noqa: E402


def train_candidate(dataset: str, action_gap: int, iterations: int,
                    coef: float, rollout_len: int, out: str, seed: int = 0):
    import jax

    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64,
                            od_randomize=dataset in OD_RANDOMIZE,
                            global_reward_coef=coef)
    md = _max_delta(dataset, env.spec_agents.gate_link_widths)
    tr = BatchedPPOTrainer(env.core, num_envs=256, rollout_len=rollout_len,
                           gate_anchor="open", max_delta=md,
                           net_type="attention", randomize=True,
                           randomize_fraction=1.0, lr=1e-4, epochs=4,
                           minibatches=4, kl_target=0.02, reward_scale=1e-4)
    ts = tr.init(jax.random.PRNGKey(seed))
    curve = []
    t0 = time.time()
    for i in range(iterations):
        t_it = time.time()
        ts, m = tr.train_iteration(ts)
        rew = float(sum(v for k, v in m.items() if k.endswith("/reward")))
        curve.append({"iteration": i, "reward": rew,
                      "wall_s": round(time.time() - t_it, 3)})
        if i % 20 == 0 or i == iterations - 1:
            print(f"[{dataset} coef={coef} T={rollout_len}] iter {i}: "
                  f"reward {rew:.0f}", flush=True)
    _export_ppo(out, tr, ts, env, "attention", iterations, dataset, 256,
                rollout_len, action_gap, time.time() - t0, curve,
                extra={"global_reward_coef": coef})
    return curve


def eval_candidate(dataset: str, action_gap: int, ckpt: str, out_dir: str):
    from pednstream_tpu.rl.evaluate import evaluate_agents

    res = evaluate_agents(dataset, ["ppo"], num_runs=3, output_dir=out_dir,
                          obs_mode="option2", action_gap=action_gap,
                          checkpoint_dirs={"ppo": ckpt})
    runs = res["ppo"]

    def mean(k):
        vals = [r[k] for r in runs if k in r]
        return sum(vals) / len(vals) if vals else None

    return {
        "reward_mean": mean("total_reward"),
        "reward_per_run": [r["total_reward"] for r in runs],
        "total_delay_mean": mean("delay.total_delay"),
        "served_trips_mean": mean("served_trips.served_trips_rate"),
        "avg_tt_mean": mean("travel_time.avg_travel_time"),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="metered_corridor",
                   choices=list(DATASETS))
    p.add_argument("--coefs", type=float, nargs="+", default=[0.0, 0.1, 0.3])
    p.add_argument("--rollout-lens", type=int, nargs="+", default=[16])
    p.add_argument("--iters", type=int, default=None)
    args = p.parse_args()

    action_gap, d_ppo, _ = DATASETS[args.dataset]
    iters = args.iters or d_ppo
    base = os.path.join("outputs", f"ablate_{args.dataset}")
    rows = []
    for T in args.rollout_lens:
        for coef in args.coefs:
            tag = f"coef{coef:g}_T{T}"
            ckpt = os.path.join(base, tag)
            curve = train_candidate(args.dataset, action_gap, iters, coef,
                                    T, ckpt)
            scores = eval_candidate(args.dataset, action_gap, ckpt,
                                    os.path.join(base, f"eval_{tag}"))
            row = {"dataset": args.dataset, "coef": coef, "rollout_len": T,
                   "iters": iters,
                   "train_reward_start": curve[0]["reward"],
                   "train_reward_last10": (sum(c["reward"]
                                               for c in curve[-10:])
                                           / len(curve[-10:])),
                   **scores}
            rows.append(row)
            print("ABLATE " + json.dumps(row), flush=True)
    with open(os.path.join(base, "ablation.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {os.path.join(base, 'ablation.json')}")


if __name__ == "__main__":
    main()
