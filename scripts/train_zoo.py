"""Train the agent zoo and produce the RL-vs-baselines results table.

Counterpart of the reference's rl/train_rl.py:35-247 (train, then
evaluate RL vs rule-based vs no-control over randomized runs) and its
shipped rl/{ppo,sac,...}_agents_<dataset> checkpoint zoos — built the
batched way: PPO trains with the batched attention-LSTM trainer (256
domain-randomized replicas in one XLA program), SAC through the host
loop, and the checkpoints are exported in the PPOAgent/SACAgent format
that rl.evaluate loads.

Run:  python scripts/train_zoo.py --dataset butterfly_scC
      python scripts/train_zoo.py --all          # full zoo (long)
"""

import argparse
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASETS = {
    # dataset -> (action_gap, ppo_iters, sac_episodes)
    "butterfly_scA": (15, 120, 30),
    "butterfly_scB": (15, 120, 30),
    "butterfly_scC": (15, 120, 30),
    "two_coordinators": (15, 100, 20),
    "45_intersections": (15, 100, 20),
    # reference-zoo breadth (rl/ppo_agents_one_intersection_v0,
    # rl/ppo_agents_small_network) + the one shipped SEPARATOR scenario
    # (data/long_corridor/sim_params.yaml controllers.links: ["2-3"])
    "one_intersection_v0": (15, 100, 30),
    "small_network": (15, 100, 30),
    "long_corridor": (10, 120, 30),
    # round-4 purpose-built metering scenario (no reference analog):
    # demand bursts overload an ungated bottleneck behind a gated
    # feeder; see data/metered_corridor/sim_params.yaml for the physics
    "metered_corridor": (5, 120, 30),
}

# datasets whose trainers should ALSO randomize OD-node activation in
# the vmapped replicas (the eval protocol's randomize_network moves
# origins/destinations via k-hop edits — training must see that
# distribution where it changes the control problem)
OD_RANDOMIZE = {"metered_corridor"}

# per-dataset action-scale override hook.  Empirically the default (max
# over the gate's link widths) wins even on metered_corridor, where the
# 20 m plaza-side link sets tanh-scale 20 for a 0-2 m feeder: the wide
# scale's aggressive width-space exploration finds the closure
# catastrophe (and the metering optimum) faster than a feeder-matched
# scale 2.0, which converged to do-nothing on 4 of 4 retrain seeds
# (every candidate was refused by the no-regress gates).
ACTION_SCALE: dict = {}

# per-dataset TRAINING-time delay-aligned reward shaping
# (env/core.py global_reward_coef: a small shared -coef * total
# in-network count term; evaluation envs always use 0.0 so eval rewards
# stay the reference signal).  Populated per scripts/
# ablate_global_reward.py results — see docs/RESULTS.md.
GLOBAL_REWARD_COEF: dict = {}


def _max_delta(dataset: str, gate_widths) -> float:
    if dataset in ACTION_SCALE:
        return ACTION_SCALE[dataset]
    return float(max((w.max() for w in gate_widths), default=2.5))

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts", "zoo")


def _validate_ppo_dir(dataset: str, action_gap: int, ckpt_dir: str,
                      episodes: int = 1, seed: int = 123):
    """Greedy-policy validation of an exported checkpoint: mean total
    true reward over one NOMINAL and one randomized episode (the nominal
    run is what the paired evaluation leads with — training reward alone
    is blind to a nominal-regime collapse)."""
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.rl_utils import load_all_agents, validate_agents
    from pednstream_tpu.rl.train import build_agents

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64)
    agents = build_agents(env, algo="ppo")
    load_all_agents(agents, ckpt_dir)
    nominal = validate_agents(env, agents, num_episodes=episodes,
                              randomize=False)
    randomized = validate_agents(env, agents, num_episodes=episodes,
                                 randomize=True)
    return nominal + randomized, {"nominal": nominal, "randomized": randomized}


def train_ppo(dataset: str, action_gap: int, iterations: int,
              num_envs: int = 256, rollout_len: int = 16, seed: int = 0,
              use_mesh: bool = False, net_type: str = "attention",
              prefix: str = "ppo", seeds: int = 1):
    import jax

    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer

    mesh = None
    if use_mesh:
        from pednstream_tpu.parallel import make_mesh

        mesh = make_mesh()  # all visible devices on the env axis
        print(f"[{dataset}] training sharded over {mesh.devices.size} devices",
              flush=True)
    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64,
                            od_randomize=dataset in OD_RANDOMIZE,
                            global_reward_coef=GLOBAL_REWARD_COEF.get(
                                dataset, 0.0))
    # open-anchored gate actions: absolute target = full-open + learned
    # offset (integrator-free; a zero policy IS no-control).  The offset
    # range must cover full closure, so max_delta = the widest gate.
    import numpy as np
    gw = env.spec_agents.gate_link_widths
    md = _max_delta(dataset, gw)
    tr = BatchedPPOTrainer(env.core, num_envs=num_envs, rollout_len=rollout_len,
                           mesh=mesh, gate_anchor="open", max_delta=md,
                           net_type=net_type, randomize=True,
                           # randomized-only worlds (the reference's
                           # setup).  Mixing in nominal heavy-demand
                           # replicas (randomize_fraction < 1) was tried
                           # and reliably collapses the policy: in jammed
                           # regimes closing a gate improves the local
                           # reward short-term (out-links drain) while
                           # the spillback catastrophe lies beyond GAE's
                           # effective horizon.
                           randomize_fraction=1.0,
                           lr=1e-4, epochs=4, minibatches=4,
                           kl_target=0.02,  # reference PPO kl_target
                           # rewards are -(travel-time sums) over action_gap
                           # engine steps: ~1e4-1e5 per RL step on jammed
                           # scenarios; scale into a sane value-target range
                           reward_scale=1e-4)

    # seed selection (the reference's validate-and-save-best practice,
    # rl_utils.py:437-496, applied across seeds): train `seeds`
    # independent runs reusing ONE compiled trainer, score each exported
    # checkpoint by greedy validation on a nominal + a randomized
    # episode, ship the best.  Training reward alone masked
    # nominal-regime collapses (it is measured on randomized worlds).
    best = None
    select = seeds > 1
    for s in range(seeds):
        ts = tr.init(jax.random.PRNGKey(seed + 1000 * s))
        curve = []
        snap, snap_rew, snap_iter = None, -float("inf"), -1
        t0 = time.time()
        for i in range(iterations):
            t_it = time.time()
            ts, m = tr.train_iteration(ts)
            rew = float(sum(v for k, v in m.items() if k.endswith("/reward")))
            # per-iteration wall time: iteration 0 carries the trainer
            # compile, so RESULTS.md can split compile vs steady-state
            curve.append({"iteration": i, "reward": rew,
                          "wall_s": round(time.time() - t_it, 3),
                          **{k: v for k, v in m.items()}})
            # validate-and-save-best analog (reference rl_utils.py:
            # 437-496): training is not monotone — snapshot the params at
            # the best training reward after warmup so a late collapse
            # does not decide the shipped checkpoint
            if select and i >= iterations // 4 and rew > snap_rew:
                import jax as _jax

                snap_rew, snap_iter = rew, i
                snap = (_jax.device_get(ts.params),
                        _jax.device_get(ts.value_params))
            if i % 20 == 0 or i == iterations - 1:
                print(f"[{dataset}] ppo seed {s} iter {i}: reward {rew:.0f}",
                      flush=True)
        train_time = time.time() - t0
        cands = [dict(ts=ts, curve=curve, train_time=train_time, seed=s,
                      which="final", score=0.0, detail={})]
        if snap is not None and snap_iter < iterations - 1:
            ts_snap = ts.replace(params=snap[0], value_params=snap[1])
            cands.append(dict(ts=ts_snap, curve=curve, train_time=train_time,
                              seed=s, which=f"best-train-iter{snap_iter}",
                              score=0.0, detail={}))
        for cand in cands:
            if select:
                tmp = os.path.join(ART, f".seedtmp_{prefix}_{dataset}")
                _export_ppo(tmp, tr, cand["ts"], env, net_type, iterations,
                            dataset, num_envs, rollout_len, action_gap,
                            train_time, curve)
                score, detail = _validate_ppo_dir(dataset, action_gap, tmp)
                cand["score"], cand["detail"] = score, detail
                print(f"[{dataset}] ppo seed {s} [{cand['which']}] "
                      f"validation: {detail}", flush=True)
            if best is None or cand["score"] > best["score"]:
                best = cand
    ts, curve, train_time = best["ts"], best["curve"], best["train_time"]
    if select:
        print(f"[{dataset}] ppo selected seed {best['seed']} "
              f"[{best['which']}] (validation {best['detail']})", flush=True)
        import shutil

        tmp = os.path.join(ART, f".seedtmp_{prefix}_{dataset}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)

    out = os.path.join(ART, f"{prefix}_agents_{dataset}")
    extra = {"seeds_trained": seeds,
             "selected_seed": best.get("seed", 0),
             "selected_checkpoint": best.get("which", "final"),
             "seed_validation": best.get("detail", {})}
    if os.path.isdir(out) and os.path.exists(os.path.join(out, "config.json")):
        # no-regress gate (same protocol as the SAC path): rescore BOTH
        # the shipped checkpoint and the candidate under the same
        # deterministic validation seed, and only overwrite on a win —
        # stored scores are not comparable across runs, and a retrain
        # must never silently replace a better policy
        import shutil
        import tempfile

        cand = tempfile.mkdtemp(prefix=f"ppo_{dataset}_cand_")
        _export_ppo(cand, tr, ts, env, net_type, iterations, dataset,
                    num_envs, rollout_len, action_gap, train_time, curve,
                    extra=extra)
        cand_score, _ = _validate_ppo_dir(dataset, action_gap, cand)
        shipped_score, _ = _validate_ppo_dir(dataset, action_gap, out)
        if cand_score <= shipped_score:
            keep = out + ".candidate"
            if os.path.isdir(keep):
                shutil.rmtree(keep)
            shutil.move(cand, keep)
            print(f"[{dataset}] ppo candidate {cand_score:.0f} does not "
                  f"beat shipped {shipped_score:.0f} (same-protocol "
                  f"rescore); keeping existing checkpoint, candidate at "
                  f"{keep}", flush=True)
            return out
        shutil.rmtree(out)
        shutil.move(cand, out)
        print(f"[{dataset}] ppo candidate {cand_score:.0f} beats shipped "
              f"{shipped_score:.0f}; replaced", flush=True)
    else:
        _export_ppo(out, tr, ts, env, net_type, iterations, dataset,
                    num_envs, rollout_len, action_gap, train_time, curve,
                    extra=extra)
    print(f"[{dataset}] ppo done in {train_time:.0f}s -> {out}", flush=True)
    return out


def _export_ppo(out, tr, ts, env, net_type, iterations, dataset, num_envs,
                rollout_len, action_gap, train_time, curve, extra=None):
    """Export trainer params as per-agent PPOAgent-format checkpoints so
    rl.evaluate's build_agents + load_all_agents pick them up directly
    (the trainer and PPOAgent share the same Flax modules)."""
    import jax

    os.makedirs(out, exist_ok=True)
    fpl = 4  # option2
    sep_ids = env.spec_agents.sep_ids
    for aid, meta in tr.agents.items():
        if aid == "sep":
            # the trainer's separator pseudo-agent covers all separators
            # jointly; with exactly one it maps 1:1 onto the eval-side
            # PPOAgent (flat LSTM, obs_dim 4, act_dim 1) and exports
            # under the discovered sep_u_v id
            if len(sep_ids) != 1:
                continue
            fname, a_net, a_fpl = f"{sep_ids[0]}.pkl", "lstm", None
        else:
            fname, a_net, a_fpl = f"{aid}.pkl", net_type, fpl
        with open(os.path.join(out, fname), "wb") as f:
            pickle.dump({
                "config": {
                    "obs_dim": meta["obs_dim"], "act_dim": meta["act_dim"],
                    "features_per_link": a_fpl, "net_type": a_net,
                    "hidden_dim": tr.hidden_dim, "gamma": tr.gamma,
                    "lmbda": tr.lmbda, "eps_clip": tr.eps_clip,
                    "epochs": tr.epochs, "kl_target": tr.kl_target,
                    "max_delta": tr.max_delta,
                    "gate_anchor": tr.gate_anchor,
                },
                "actor": jax.device_get(ts.params[aid]),
                "critic": jax.device_get(ts.value_params[aid]),
                "episode": iterations,
            }, f)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({"dataset": dataset, "trainer": "BatchedPPOTrainer",
                   "net_type": net_type, "randomize": True,
                   "num_envs": num_envs, "rollout_len": rollout_len,
                   "iterations": iterations, "action_gap": action_gap,
                   "obs_mode": "option2", "train_time_s": round(train_time, 1),
                   "engine_steps": num_envs * rollout_len * action_gap * iterations,
                   **(extra or {})},
                  f, indent=2)
    with open(os.path.join(out, "curve.json"), "w") as f:
        json.dump(curve, f)


def _validate_sac_dir(dataset: str, action_gap: int, ckpt_dir: str,
                      episodes: int = 1, seed: int = 123,
                      nominal_only: bool = False):
    """Greedy validation of an exported SAC checkpoint through the host
    eval harness (wrapper + norm stats), scoring nominal and randomized
    episodes like the PPO seed selection."""
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.rl_utils import (
        RunningNormalizeWrapper, load_all_agents, validate_agents)
    from pednstream_tpu.rl.train import build_agents

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64)
    wrapped = RunningNormalizeWrapper(env)
    agents = build_agents(wrapped, algo="sac", seed=seed)
    load_all_agents(agents, ckpt_dir, env=wrapped)
    # freeze the loaded obs statistics so validation scores the policy
    # under the SAME normalization evaluate.py will use — otherwise the
    # stats drift during the validation episodes and the
    # snapshot-selection protocol disagrees with the final eval protocol
    wrapped.freeze()
    nominal = validate_agents(wrapped, agents, num_episodes=episodes,
                              randomize=False)
    if nominal_only:
        return nominal, {"nominal": nominal}
    randomized = validate_agents(wrapped, agents, num_episodes=episodes,
                                 randomize=True)
    return nominal + randomized, {"nominal": nominal, "randomized": randomized}


def train_sac_batched(dataset: str, action_gap: int, iterations: int = 300,
                      seed: int = 0, num_envs: int = 64, val_every: int = 25,
                      randomize_fraction: float = 0.75,
                      use_mesh: bool = False):
    """SAC through the batched trainer (rl/batched_sac.py):
    64 lockstep domain-randomized replicas + scanned updates give a
    ~20x gradient-step budget over the host loop in a fraction of the
    wall-clock — the round-3 fix for the underfit SAC zoo rows.

    Ships the best VALIDATED snapshot (host-harness greedy episodes on a
    nominal + a randomized world), and only overwrites an existing
    checkpoint if the candidate beats its stored nominal-protocol
    val_reward (no-regress gate, as train_sac)."""
    import shutil
    import tempfile

    import jax

    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_sac import BatchedSACTrainer

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64,
                            od_randomize=dataset in OD_RANDOMIZE,
                            global_reward_coef=GLOBAL_REWARD_COEF.get(
                                dataset, 0.0))
    mesh = None
    if use_mesh:
        from pednstream_tpu.parallel import make_mesh

        mesh = make_mesh()  # all visible devices on the env axis
        print(f"[{dataset}] SAC training sharded over {mesh.devices.size} "
              "devices", flush=True)
    gw = env.spec_agents.gate_link_widths
    md = _max_delta(dataset, gw)
    tr = BatchedSACTrainer(env.core, num_envs=num_envs, mesh=mesh,
                           collect_steps=8,
                           updates_per_iter=64, batch_size=256,
                           buffer_capacity=65536, warmup_transitions=2048,
                           max_delta=md, gate_anchor="open",
                           # off-policy replay tolerates mixed worlds:
                           # keep 1-in-4 replicas on the nominal world so
                           # the policy sees the congestion regime the
                           # paired evaluation leads with (the host loop
                           # does the same per-episode); jam-heavy scenarios
                           # may need a nominal-heavy mix (fraction < 0.5)
                           randomize=True,
                           randomize_fraction=randomize_fraction)
    ts = tr.init(jax.random.PRNGKey(seed))
    out = os.path.join(ART, f"sac_agents_{dataset}")
    tmp = tempfile.mkdtemp(prefix=f"bsac_{dataset}_")
    best_score, best_dir, curve = -float("inf"), None, []
    t0 = time.time()
    try:
        for i in range(iterations):
            t_it = time.time()
            ts, m = tr.train_iteration(ts)
            curve.append({"iteration": i, "reward": m["reward"],
                          "wall_s": round(time.time() - t_it, 3),
                          **{k: v for k, v in m.items()}})
            if (i + 1) % val_every == 0 or i == iterations - 1:
                cand = os.path.join(tmp, f"it{i}")
                tr.export(ts, cand)
                score, parts = _validate_sac_dir(dataset, action_gap, cand)
                print(f"[{dataset}] bsac it {i}: train {m['reward']:.0f} "
                      f"val {parts}", flush=True)
                if score > best_score:
                    best_score, best_dir = score, cand
        if best_dir is None:
            print(f"[{dataset}] bsac: no validated snapshot", flush=True)
            return out
        # no-regress gate against the SHIPPED checkpoint — re-scored NOW
        # under the identical protocol (same validation env seed, same
        # episode sequence), NOT against its stored val_reward: stored
        # numbers come from whatever nominal demand draw the original
        # training run's env produced (long_corridor ships unseeded, so
        # a light draw once scored -109k where the same checkpoint
        # scores -285k on the eval run0 world)
        cand_nom, _ = _validate_sac_dir(dataset, action_gap, best_dir,
                                        episodes=3, nominal_only=True)
        cfg_path = os.path.join(out, "config.json")
        prev = None
        if os.path.exists(cfg_path):
            try:
                prev, _ = _validate_sac_dir(dataset, action_gap, out,
                                            episodes=3, nominal_only=True)
            except Exception as e:  # unreadable checkpoint: replace it
                print(f"[{dataset}] bsac: shipped checkpoint unscorable "
                      f"({e}); replacing", flush=True)
        if prev is not None and cand_nom <= float(prev):
            # keep the refused candidate next to the shipped dir so a
            # protocol change can re-judge it without a retrain
            keep = out + ".candidate"
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(best_dir, keep)
            print(f"[{dataset}] bsac candidate {cand_nom:.0f} does not beat "
                  f"shipped {float(prev):.0f} (same-protocol rescore); "
                  f"keeping existing checkpoint, candidate at {keep}",
                  flush=True)
            return out
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(best_dir):
            shutil.copy(os.path.join(best_dir, f), os.path.join(out, f))
        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg.setdefault("extra", {}).update(
            val_reward=cand_nom, trainer="batched_sac",
            iterations=iterations, num_envs=num_envs,
            gradient_steps=iterations * 64)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        with open(os.path.join(out, "curve.json"), "w") as f:
            json.dump(curve, f)
        print(f"[{dataset}] bsac done in {time.time()-t0:.0f}s "
              f"-> {out} (val {cand_nom:.0f})", flush=True)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_sac(dataset: str, action_gap: int, episodes: int, seed: int = 0,
              updates_per_step: int = 1):
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.rl_utils import RunningNormalizeWrapper
    from pednstream_tpu.rl.train import build_agents, train_off_policy_multi_agent

    env = PedNetParallelEnv(dataset, obs_mode="option2", seed=seed,
                            action_gap=action_gap, history_window=64)
    wrapped = RunningNormalizeWrapper(env)
    agents = build_agents(env, algo="sac", seed=seed)
    # open-anchored gate actions, as for PPO: zero output IS no-control,
    # so exploration is centered on the sane baseline instead of the
    # current-width integrator's closure drift; the offset range must
    # cover full closure
    gw = env.spec_agents.gate_link_widths
    md = _max_delta(dataset, gw)
    for aid, a in agents.items():
        if aid.startswith("gate"):
            a.gate_anchor = "open"
            a.max_delta = md
    t0 = time.time()
    out = os.path.join(ART, f"sac_agents_{dataset}")
    # save_dir makes the loop ship the best VALIDATED state (nominal
    # greedy episodes, validate_and_save_best) rather than whatever the
    # last gradient step left behind — off-policy training on these
    # scenarios is visibly non-monotone (round-2 zoo shipped a
    # post-collapse scC checkpoint 1.8x worse than no-control)
    # updates_per_step stays at 1: raising the replay ratio to 4 was
    # tried (100-episode runs) and reliably destabilized SAC on these
    # scenarios — every validation snapshot scored 2-7x worse than
    # no-control (critic overestimation spiral on a tiny buffer)
    def _val_score():
        try:
            with open(os.path.join(out, "config.json")) as f:
                return json.load(f).get("extra", {}).get("val_reward")
        except (OSError, json.JSONDecodeError):
            return None

    before = _val_score()
    history = train_off_policy_multi_agent(
        wrapped, agents, num_episodes=episodes, randomize=True,
        warmup_steps=100, save_dir=out, val_freq=5,
        updates_per_step=updates_per_step,
        log_fn=lambda ep, h: print(
            f"[{dataset}] sac ep {ep}: reward {h['reward']:.0f}", flush=True)
        if ep % 5 == 0 else None,
    )
    # curve.json must describe the SHIPPED checkpoint's training run:
    # with the no-regress gate a repeat run that never beat the stored
    # validation score leaves the checkpoint (and so the curve) alone
    if _val_score() != before or before is None:
        with open(os.path.join(out, "curve.json"), "w") as f:
            json.dump(history, f)
    print(f"[{dataset}] sac done in {time.time()-t0:.0f}s -> {out}", flush=True)
    return out


def evaluate_zoo(dataset: str, action_gap: int, ppo_dir: str,
                 sac_dir: str = None, with_mpc: bool = False,
                 num_runs: int = 3):
    from pednstream_tpu.rl.evaluate import evaluate_agents, summarize

    algos = ["ppo", "rule_based", "no_control"]
    ckpts = {"ppo": ppo_dir}
    if sac_dir:
        algos.insert(1, "sac")
        ckpts["sac"] = sac_dir
    out_dir = f"outputs/eval_{dataset}"
    results = evaluate_agents(dataset, algos, num_runs=num_runs,
                              output_dir=out_dir, obs_mode="option2",
                              action_gap=action_gap, checkpoint_dirs=ckpts)
    if with_mpc and dataset != "long_corridor":
        # the MPC baseline controls GATES only (reference
        # optimization_based.py has no separator support); long_corridor
        # is separator-only, so an MPC row there would duplicate
        # no_control.  Same num_runs as every other policy: the paired
        # protocol (run 0 nominal, runs 1+ randomized, same seeds) is
        # what makes the cross-policy comparison honest — a single-run
        # MPC row is not comparable to 3-run means (round-4 lesson).
        t_mpc = time.time()
        mpc = evaluate_agents(dataset, ["optimization"], num_runs=num_runs,
                              output_dir=out_dir, obs_mode="option2",
                              action_gap=action_gap)
        rows = mpc.get("optimization", [])
        for row in rows:
            row["wall_s"] = round((time.time() - t_mpc) / max(len(rows), 1), 1)
        results.update(mpc)
    table = summarize(results)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    # durable copy: outputs/ is scratch and does not survive between
    # sessions; scripts/make_results_md.py regenerates the doc from
    # artifacts/eval/ (tracked) with outputs/ taking precedence when
    # fresher
    durable = os.path.join(os.path.dirname(ART), "eval", dataset)
    os.makedirs(durable, exist_ok=True)
    with open(os.path.join(durable, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    with open(os.path.join(out_dir, "table.txt"), "w") as f:
        f.write(table + "\n")
    print(f"== {dataset} ==\n{table}", flush=True)
    return results


def run(dataset: str, skip_sac: bool = False, skip_eval: bool = False,
        with_mpc: bool = False, ppo_iters: int = None, sac_eps: int = None,
        eval_only: bool = False, use_mesh: bool = False,
        sac_batched: bool = False, sac_iters: int = 300,
        skip_ppo: bool = False):
    action_gap, d_ppo, d_sac = DATASETS[dataset]
    ppo_dir = os.path.join(ART, f"ppo_agents_{dataset}")
    if not eval_only and not skip_ppo:
        ppo_dir = train_ppo(dataset, action_gap, ppo_iters or d_ppo,
                            use_mesh=use_mesh)
    sac_dir = os.path.join(ART, f"sac_agents_{dataset}")
    if not skip_sac and not eval_only:
        if sac_batched:
            sac_dir = train_sac_batched(dataset, action_gap, sac_iters,
                                        use_mesh=use_mesh)
        else:
            sac_dir = train_sac(dataset, action_gap, sac_eps or d_sac)
    elif not os.path.isdir(sac_dir):
        sac_dir = None  # no previously trained SAC checkpoint to reuse
    if not skip_eval:
        evaluate_zoo(dataset, action_gap, ppo_dir, sac_dir, with_mpc=with_mpc)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default=None, choices=list(DATASETS))
    p.add_argument("--all", action="store_true")
    p.add_argument("--skip-sac", action="store_true")
    p.add_argument("--skip-ppo", action="store_true",
                   help="reuse the shipped PPO checkpoint (SAC-only "
                        "retrain); eval still covers both")
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument("--with-mpc", action="store_true")
    p.add_argument("--ppo-iters", type=int, default=None)
    p.add_argument("--sac-episodes", type=int, default=None)
    p.add_argument("--sac-batched", action="store_true",
                   help="train SAC with the batched trainer "
                        "(rl/batched_sac.py) instead of the host loop")
    p.add_argument("--sac-iters", type=int, default=300,
                   help="batched-SAC training iterations (64 gradient "
                        "steps each)")
    p.add_argument("--eval-only", action="store_true",
                   help="re-evaluate existing artifacts/zoo checkpoints "
                        "without retraining")
    p.add_argument("--mesh", action="store_true",
                   help="shard training over all visible devices (the "
                        "trainer establishes the env-axis shardings)")
    args = p.parse_args()

    names = list(DATASETS) if args.all else [args.dataset or "butterfly_scC"]
    for name in names:
        run(name, skip_sac=args.skip_sac, skip_eval=args.skip_eval,
            with_mpc=args.with_mpc,
            ppo_iters=args.ppo_iters, sac_eps=args.sac_episodes,
            eval_only=args.eval_only, use_mesh=args.mesh,
            sac_batched=args.sac_batched, sac_iters=args.sac_iters,
            skip_ppo=args.skip_ppo)


if __name__ == "__main__":
    main()
