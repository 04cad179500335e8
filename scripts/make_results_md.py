"""Assemble docs/RESULTS.md from the zoo evaluation outputs
(outputs/eval_<dataset>/results.json produced by scripts/train_zoo.py).

Run:  python scripts/make_results_md.py
"""

import glob
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

METRICS = [
    ("total_reward", "total reward", 0),
    ("throughput.throughput", "throughput", 3),
    ("travel_time.avg_travel_time", "avg travel time [s]", 1),
    ("delay.total_delay", "total delay", 0),
    ("served_trips.served_trips_rate", "served-trips rate", 3),
    ("congestion.avg_congestion_density", "congestion density", 3),
]


def render_dataset(name: str, results: dict) -> str:
    lines = [f"### {name}", ""]
    header = "| policy | " + " | ".join(label for _, label, _ in METRICS) + " |"
    lines += [header, "|" + "---|" * (len(METRICS) + 1)]
    for algo, runs in results.items():
        row = [algo]
        for key, _, nd in METRICS:
            vals = [r.get(key) for r in runs if r.get(key) is not None]
            row.append(f"{np.mean(vals):.{nd}f}" if vals else "—")
        lines.append("| " + " | ".join(row) + " |")
    if name.startswith("one_intersection_v0"):
        lines += ["", "**Oversaturated by construction — rows shown for "
                  "zoo breadth, not discrimination.** The nominal world "
                  "(run 0) saturates every policy: a fixed-split sweep at "
                  "1.0/0.75/0.5/0.25x full gate width scores "
                  "-4.24M/-4.64M/-4.99M/-5.31M, i.e. fully-open is the "
                  "best static policy and every restriction is strictly "
                  "worse, so there is no controllable headroom and all "
                  "policies land at the open-gate jam cost (~-4.2M). The "
                  "randomized runs (1+) carry the discriminating signal."]
    if "long_corridor" in name and "optimization" not in results:
        lines += ["", "(no `optimization` row: the MPC baseline ports the "
                  "reference's DecentralizedOptimizationAgent, which controls "
                  "gater intersections only — optimization_based.py has no "
                  "separator model; long_corridor's sole agent is a "
                  "Separator)"]
    # per-run rewards for the paired comparison
    lines += ["", "Per-run total reward (run 0 = nominal world, runs 1+ = "
              "paired randomized worlds):", ""]
    nc = {r["run"]: r["total_reward"] for r in results.get("no_control", [])}
    for algo, runs in results.items():
        rr = ", ".join(f"run{r['run']}: {r['total_reward']:.0f}" for r in runs)
        extra = ""
        if algo == "optimization" and runs and runs[0].get("wall_s"):
            n = len(runs)
            protocol = ("single run" if n == 1
                        else f"full {n}-run paired protocol")
            extra = (f" ({protocol} — the DE inner optimizer costs "
                     f"{runs[0]['wall_s']:.0f}s wall per episode)")
        bad = [r["run"] for r in runs
               if nc.get(r["run"], 0) < 0
               and r["total_reward"] / nc[r["run"]] > 1.5]
        if bad and algo == "sac":
            extra += (f" — **known-weak on run{'/'.join(map(str, bad))}** "
                      "(>1.5x worse than no-control): the host-loop SAC "
                      "budget (30 episodes ≈ 1.2k gradient steps) underfits "
                      "this scenario's nominal congestion regime; the "
                      "validation-gated, no-regress checkpointing in "
                      "scripts/train_zoo.py ships the best seed seen so far")
        lines.append(f"- **{algo}**: {rr}{extra}")
    lines.append("")
    return "\n".join(lines)


def summarize_wins(all_results: dict) -> list:
    """One line per dataset ranking every trained policy on BOTH axes:
    total reward (the reference-inherited training signal — local to
    each agent's own links and clamped at the engine's jam travel-time)
    and network-wide total delay (the offline metric, unclamped, over
    every link).  The two can diverge by design: a gate's reward never
    sees a gridlocked link elsewhere in the network, so a policy that
    prevents a network collapse can look reward-neutral.  Generated from
    the data instead of hand-written."""
    lines = []
    for name, results in all_results.items():
        base = [np.mean([r["total_reward"] for r in results[a]])
                for a in ("no_control", "rule_based") if a in results]
        if not base:
            continue
        bar = max(base)
        nc_runs = results.get("no_control", [])
        nc = np.mean([r["total_reward"] for r in nc_runs]) if nc_runs else bar
        nc_delays = [r["delay.total_delay"] for r in nc_runs
                     if "delay.total_delay" in r]
        # older results.json rows predate the delay metrics: an empty
        # list would make np.mean() a NaN that passes truthiness and
        # prints "+nan% network delay" — omit the axis instead
        nc_delay = np.mean(nc_delays) if nc_delays else None
        rows = []
        for algo, runs in results.items():
            if algo in ("no_control", "rule_based"):
                continue
            mean = np.mean([r["total_reward"] for r in runs])
            rel = (mean - nc) / abs(nc) * 100
            tag = "beats both baselines" if mean > bar else (
                "ties baselines" if mean > 1.05 * bar else "trails")
            part = f"{algo} {tag} ({rel:+.1f}% reward"
            d = [r["delay.total_delay"] for r in runs
                 if "delay.total_delay" in r]
            if d and nc_delay:
                dd = (np.mean(d) - nc_delay) / nc_delay * 100
                part += f", {dd:+.0f}% network delay"
            rows.append(part + " vs no-control)")
        lines.append(f"- **{name}**: " + "; ".join(rows))
    return lines


def _eval_paths():
    """One results.json per dataset.  Durable copies live in
    artifacts/eval/<dataset>/ (tracked — outputs/ is scratch and does
    not survive between sessions; regenerating the doc from outputs/
    alone silently DROPS every dataset whose eval was not re-run this
    session).  A fresher outputs/eval_<dataset>/results.json overrides
    the durable copy; train_zoo.evaluate_zoo writes both."""
    paths = {}
    for path in sorted(glob.glob(os.path.join(REPO, "artifacts", "eval",
                                              "*", "results.json"))):
        paths[os.path.basename(os.path.dirname(path))] = path
    for path in sorted(glob.glob(os.path.join(REPO, "outputs", "eval_*",
                                              "results.json"))):
        name = os.path.basename(os.path.dirname(path))[len("eval_"):]
        # "fresher overrides" by mtime, literally: a stale scratch copy
        # lingering from an earlier session must not shadow a durable
        # artifact updated out-of-band (e.g. pulled eval results)
        if (name not in paths
                or os.path.getmtime(path) >= os.path.getmtime(paths[name])):
            paths[name] = path
    return [paths[k] for k in sorted(paths)]


def main():
    sections = []
    curves = []
    all_results = {}
    for path in _eval_paths():
        name = os.path.basename(os.path.dirname(path))
        if name.startswith("eval_"):
            name = name[len("eval_"):]
        with open(path) as f:
            results = json.load(f)
        all_results[name] = results
        if name == "45_intersections_lstm":
            # the lstm-variant eval trained/evaluated only the lstm_ppo
            # policy; borrow the baselines from 45_intersections (a
            # byte-identical dataset, same paired eval seeds) so the
            # summary can rank it
            base_path = next((p for p in _eval_paths()
                              if "45_intersections" in p
                              and "lstm" not in p), None)
            if base_path:
                with open(base_path) as f:
                    base = json.load(f)
                merged = dict(results)
                for a in ("no_control", "rule_based"):
                    if a in base:
                        merged[a] = base[a]
                all_results[name] = merged
        if name == "45_intersections":
            # byte-identical to two_coordinators (verified against the
            # reference with diff -r) — one table, different seed noted
            name = ("45_intersections (byte-identical dataset to "
                    "two_coordinators; second training seed)")
        elif name == "45_intersections_lstm":
            name = ("45_intersections — lstm_ppo family variant "
                    "(reference rl/lstm_ppo_agents_45_intersections)")
        sections.append(render_dataset(name, results))
        base = os.path.basename(os.path.dirname(path))
        if base.startswith("eval_"):
            base = base[len("eval_"):]
        cj = os.path.join(REPO, "artifacts", "zoo", f"ppo_agents_{base}",
                          "curve.json")
        if os.path.exists(cj):
            with open(cj) as f:
                curve = json.load(f)
            r0 = curve[0]["reward"]
            rl = np.mean([c["reward"] for c in curve[-10:]])
            cfg = json.load(open(os.path.join(os.path.dirname(cj), "config.json")))
            # phase-controlled learning signal: the trainer's continuing
            # lockstep envs make iteration i sample a fixed WINDOW of the
            # fixed-horizon episode (rollout_len RL steps of an
            # episode_rl-step episode), so raw reward-vs-iteration mixes
            # episode phase (empty network at phase 0, burst mid-episode)
            # with learning — "start -> last-10" is phase-biased, not a
            # training direction.  Compare early vs late AT MATCHED PHASE
            # instead (see RESULTS.md "reading the training curves").
            phase_note = ""
            try:
                import yaml

                sim = yaml.safe_load(open(os.path.join(
                    REPO, "data", base, "sim_params.yaml")))
                ep_rl = int(sim["params"]["simulation_steps"]
                            // cfg["action_gap"])
                period = int(np.lcm(cfg["rollout_len"], ep_rl)
                             // cfg["rollout_len"])
                if period > 1 and len(curve) >= 2 * period:
                    r = np.array([c["reward"] for c in curve])
                    ph = np.arange(len(r)) % period
                    deltas = []
                    for p in range(period):
                        sel = r[ph == p]
                        h = len(sel) // 2
                        if h:
                            deltas.append(sel[h:].mean() - sel[:h].mean())
                    d = float(np.mean(deltas))
                    phase_note = (f"; phase-controlled improvement "
                                  f"{d:+.0f} (early->late at matched "
                                  f"episode phase, period {period})")
            except Exception:
                pass
            curves.append(
                f"- **{base}**: {len(curve)} iterations, "
                f"{cfg['engine_steps']/1e6:.1f}M engine steps; "
                f"reward {r0:.0f} (start) -> {rl:.0f} (last-10 mean)"
                f"{phase_note}"
            )
        # batched-SAC training rows
        scj = os.path.join(REPO, "artifacts", "zoo", f"sac_agents_{base}",
                           "curve.json")
        scfg_p = os.path.join(os.path.dirname(scj), "config.json")
        if os.path.exists(scj) and os.path.exists(scfg_p):
            scfg = json.load(open(scfg_p)).get("extra", {})
            if scfg.get("trainer") == "batched_sac":
                with open(scj) as f:
                    curve = json.load(f)
                curves.append(
                    f"- **{base} (batched SAC)**: {len(curve)} iterations "
                    f"x 64 gradient steps ({scfg.get('gradient_steps', 0)/1e3:.0f}k "
                    f"total, ~20x the host-loop budget)"
                )

    doc = """# Results: trained-agent zoo vs baselines

Produced by `scripts/train_zoo.py` (training) + `scripts/make_results_md.py`
(this table).  PPO = batched attention-LSTM trainer (256 per-replica
domain-randomized worlds, the reference's randomization distribution);
SAC = twin-Q, trained per dataset by whichever of the batched
trainer (`rl/batched_sac.py`, "(batched SAC)" rows below) or the
reference-style host loop validated best — retrains only replace a
checkpoint through a same-protocol no-regress gate; rule_based /
no_control / optimization(MPC) = reference baselines.  Evaluation = paired runs per
`rl.evaluate.evaluate_agents` (same seed per run across policies; run 0
nominal, later runs randomized), metrics from `rl.metrics` over the
saved runs.

## Summary (generated from the tables below)

Each line ranks policies on BOTH axes — mean total reward AND mean
network-wide total delay vs no-control; "beats both baselines" =
strictly better reward than BOTH no-control and rule-based:

{wins}

**Headline: gating decisively matters on `metered_corridor`, and
trained RL wins BOTH axes against EVERY baseline.** The bundled gater
scenarios are structurally open-optimal (front-gate cross-coupling,
below), so round 4 authored a scenario where metering provably wins: a
funnel whose demand bursts overload an ungated bottleneck behind a
gated feeder, exploiting the engine's jam-discharge collapse (a jammed
link drains ~10x below its gate capacity —
data/metered_corridor/sim_params.yaml documents the physics, and a
golden fixture pins the geometry to the reference engine bit-for-bit).
Under the identical 3-run paired protocol for ALL policies (round 5
re-ran the MPC baseline under the full protocol; its round-4 row was a
single nominal run, not comparable to 3-run means), both trained
policies beat every baseline — no-control, rule-based, AND the MPC
optimizer — on total reward AND network-wide total delay ON EVERY
PAIRED RUN, at equal-or-better served trips: SAC reward -114,507 /
delay 3.06M / served 0.760 and PPO -123,072 / 3.16M / 0.760, vs MPC
-298,789 / 3.70M / 0.755, rule-based -148,066 / 4.24M / 0.750,
no-control -341,818 / 3.85M / 0.760 (per-run: SAC delay 0.79M/4.16M/
4.22M vs MPC 1.74M/4.70M/4.67M).  The round-4 caveat "MPC wins the
delay axis" dissolved under pairing: MPC's apparent 1.72M-delay win
was its nominal-world run alone — where SAC posts 0.79M and PPO 1.03M,
both better.  Full closure is the WORST policy on this scenario by
construction (the plaza jams), so the reward cannot be gamed by
refusing service.

**Why the two axes can diverge — and why both are reported.** The
reward is the reference's training signal: each gate is paid
-(T_fwd + T_rev) over ITS OWN links only, with travel time clamped at
the engine's jam value (env/core.py `_rewards`); a gridlocked link
elsewhere in the network is nearly invisible to it. Total delay is the
offline metric: person-seconds of delay summed over EVERY link,
unclamped. On the coordinator scenarios (two_coordinators /
45_intersections, byte-identical datasets) the nominal world sits near
a jam bifurcation: uncontrolled, link 31-32 collapses to a standstill
(max link travel time 1,682,216 s, 3,596 pedestrians still in-network
at the horizon, network avg travel time 116 s), while the gated runs
keep it moving — shipped PPO posts max link travel time 2,730 s, 1,430
left in-network, avg travel time 47 s, throughput 0.937 vs 0.901 — a
2.3x run-0 total-delay reduction (1.59M vs 3.73M person-seconds) that
the clamped local reward prices at under 4% (-258,990 vs -268,916).
Trained RL beats ALL baselines on BOTH axes here too (PPO mean reward
-266,289 / delay 559k vs MPC -268,770 / 610k, rule-based -269,094 /
1.27M, no-control -269,598 / 1.27M).  Because the collapse is a
bifurcation, WHICH checkpoint catches it is sample-path sensitive: a
perf-motivated round-4 change to the stochastic fast path moved the
nominal-world jam from link 32-25 to 31-32 and swapped which trained
family posts the bigger delay win (SAC in the round-4 tables, PPO
here), while every reward moved <0.5%.  metered_corridor — where the
RL win reproduces on every paired run — is the headline scenario for
exactly this reason.

**The PPO-vs-SAC delay split is checkpoint-selection noise, not
reachability — a controlled ablation (round 5).** Round 4 observed
shipped SAC preventing the coordinator-scenario gridlock while shipped
PPO missed it; on the current engine's sample path the roles have
swapped (PPO 1.59M run-0 delay vs SAC 2.21M; both prevent the 3.73M
no-control collapse).  Three 100-iteration PPO runs on two_coordinators
under the identical paired protocol (scripts/ablate_global_reward.py;
artifacts/eval/ablations/two_coordinators_ppo.json) explain the
instability: (a) a FRESH SEED of the exact zoo configuration posts
network delay **770,965** — same class as the shipped checkpoints,
proving the gridlock-prevention behavior is reachable by the on-policy
family with no algorithmic change; (b) the delay-aligned training
reward (`global_reward_coef=0.1`, env/core.py — a small shared penalty
on total in-network count, whose engine-step sum IS total network time)
also finds it (delay 1.35M), confirming the shaped signal injects the
information the clamped local reward hides; (c) DOUBLING the GAE window
(rollout_len 64) is strictly worse at the matched iteration budget
(run-0 collapse to -975k reward, delay 12.8M) — the horizon is not the
binding constraint.  The mechanism: the clamp prices a prevented
gridlock at a few percent of reward while charging the prevention's
full local cost, so reward-validated selection is near-indifferent
between catching and missing the collapse — which axis a given seed
lands on is noise.  For delay-critical training the validated fix is
`global_reward_coef`.

On **long_corridor** (the one bundled Separator scenario), a fixed-split
sweep on the nominal world scores 1.5/1.75/2.0/2.25/2.5 m forward-width
at -648k/-163k/-135k/-438k/-1567k: the mid split is the best STATIC
policy, so the headroom for control is only the time-varying remainder —
the trained separator captures it — PPO beats every baseline on both
axes (+2.4% reward, -46% network delay vs no-control) — and the
reactive EMA rule-based allocator is 2.3x worse than either.
The long_corridor SAC row is CONVERGED, not under-trained: a round-4
retrain at 2x the gradient budget (600 iterations, --skip-ppo) produced
a best-validation snapshot scoring exactly the shipped checkpoint's
validation reward — the ~-4% reward gap vs no-control is this trainer's
plateau on the separator task (PPO remains the winning family there).

Two structural findings behind these numbers (docs/PARITY.md):
a gate width throttles BOTH directions of its corridor at the gater
node (front-gate cross-coupling, reference link.py:110-126), so
restricting any gate also restricts network inflow and fully-open is
(near-)optimal on several bundled scenarios; and training with heavy
nominal-demand worlds mixed in reliably collapses PPO to gate closure —
in jammed regimes closure improves the local reward short-term while
the spillback catastrophe lies beyond GAE's effective horizon
(rl/batched_ppo.py randomize_fraction documents this).

## Training curves

**Reading the training curves.** The batched trainer steps B continuing
lockstep replicas, so iteration i always samples the SAME rollout_len-
step window of the fixed-horizon episode; raw reward-vs-iteration
therefore mixes episode phase with learning (iteration 0 is the empty
network at episode start; mid-episode windows carry the demand burst).
The honest learning signal is the phase-controlled number on each row:
early-vs-late reward AT MATCHED episode phase.  Concretely,
metered_corridor's raw curve reads -12,279 (start) -> -26,460 (last-10
mean) — a phase artifact, not a decline: grouped by its 15-iteration
phase period, the policy improves in every loaded phase (e.g. the
heaviest burst window trains -42,838 -> -34,508; the two empty-network
phases are flat at ~-12k), phase-controlled improvement +5,013.

metered_corridor runs at action_gap 5, so an iteration carries only
20,480 engine steps (vs 61,440 at the siblings' action_gap 15).  Both
round-5 retrain candidates (PPO, and batched SAC at the same
600-iteration budget) were REFUSED by the same-protocol no-regress gate
— the shipped checkpoints validate better.  Training times are not
listed: they were taken on the previous accelerator, and the trainers
have not yet run on the H100.

{curves}

## Evaluation tables

{sections}
"""
    out = os.path.join(REPO, "docs", "RESULTS.md")
    with open(out, "w") as f:
        f.write(doc.format(wins="\n".join(summarize_wins(all_results))
                           or "(no results found)",
                           curves="\n".join(curves) or "(no curves found)",
                           sections="\n".join(sections) or "(no results found)"))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
