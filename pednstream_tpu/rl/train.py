"""Training drivers.

``train_on_policy_multi_agent`` mirrors the reference's independent-
learner episode loop (rl/agents/PPO_backup.py:762-956, rl/train_rl.py:
35-106): per-episode rollouts over a dict of agents with delta->absolute
action conversion, per-episode PPO updates, and validation-gated best
checkpointing.  ``train_off_policy_multi_agent`` is the SAC loop
(rl/agents/SAC_copy.py:157-310).

``make_dp_train_step`` is a minimal sharded policy-gradient step used
by the multi-chip dryrun: env replicas shard across the mesh's ``env``
axis via jit + NamedShardings (GSPMD inserts the cross-chip gradient
reduction automatically — there is no hand-written shard_map/pmean).
It is deliberately simple (one-step REINFORCE, no value function); the
full mesh-shardable PPO lives in rl/batched_ppo.py.  Together they are
the SPMD replacement for the reference's Ray rollout workers
(train_ppo_rllib.py:62-64).
"""

import json
import os
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from .networks import MLPPolicy
from .ppo import PPOAgent, _gaussian_logprob
from .rl_utils import validate_and_save_best
from .rule_based import NoControlAgent, RuleBasedGaterAgent, RuleBasedSeparatorAgent
from .sac import SACAgent


# -- agent construction (train_rl.py:70-95) -----------------------------------

def build_agents(env, algo: str = "ppo", net_type: str = "attention",
                 seed: int = 0, **kwargs) -> Dict[str, object]:
    from ..env.agents import FEATURES_PER_LINK, controlled_links_adjacency

    fpl = FEATURES_PER_LINK[env.obs_mode]
    agents: Dict[str, object] = {}
    spec = env.spec_agents
    for i, agent_id in enumerate(spec.agent_ids):
        space = env.action_space(agent_id)
        obs_space = env.observation_space(agent_id)
        act_dim = int(np.prod(space.shape))
        obs_dim = int(np.prod(obs_space.shape))
        if algo == "ppo":
            extra = dict(kwargs)
            if net_type == "gat" and agent_id.startswith("gate"):
                gi = spec.gate_ids.index(agent_id)
                extra["adj"] = controlled_links_adjacency(
                    env.scn, spec.gate_links[gi]
                )
            agents[agent_id] = PPOAgent(
                obs_dim=obs_dim, act_dim=act_dim,
                features_per_link=fpl if agent_id.startswith("gate") else None,
                net_type=net_type if agent_id.startswith("gate") else "lstm",
                action_low=space.low, action_high=space.high,
                seed=seed + i, **extra,
            )
        elif algo == "sac":
            agents[agent_id] = SACAgent(
                obs_dim=obs_dim, act_dim=act_dim,
                action_low=space.low, action_high=space.high,
                seed=seed + i, is_separator=agent_id.startswith("sep"),
                **kwargs,
            )
        elif algo == "rule_based":
            if agent_id.startswith("gate"):
                agents[agent_id] = RuleBasedGaterAgent(
                    act_dim=act_dim, max_widths=space.high, features_per_link=fpl
                )
            else:
                total = float(spec.sep_total_width[spec.sep_ids.index(agent_id)])
                agents[agent_id] = RuleBasedSeparatorAgent(total_width=total)
        elif algo == "no_control":
            agents[agent_id] = NoControlAgent(space.high if agent_id.startswith("gate")
                                              else (space.low + space.high) / 2)
        else:
            raise ValueError(f"unknown algo {algo}")
    return agents


# -- on-policy loop (PPO_backup.py:762-956) ------------------------------------

def train_on_policy_multi_agent(
    env,
    agents: Dict[str, PPOAgent],
    num_episodes: int = 100,
    randomize: bool = False,
    val_freq: int = 10,
    save_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
):
    history = []
    best_reward = -np.inf
    for episode in range(num_episodes):
        obs, _ = env.reset(options={"randomize": randomize})
        for a in agents.values():
            if hasattr(a, "reset_hidden"):
                a.reset_hidden()
        done = False
        ep_reward = 0.0
        while not done:
            deltas = {aid: agents[aid].take_action(obs[aid]) for aid in agents}
            actions = {
                aid: agents[aid].absolute_action(obs[aid], deltas[aid])
                for aid in agents
            }  # delta -> absolute (PPO_backup.py:848-851)
            next_obs, rewards, terms, truncs, infos = env.step(actions)
            done = any(terms.values()) or any(truncs.values())
            for aid in agents:
                if hasattr(agents[aid], "store_transition"):
                    agents[aid].store_transition(
                        obs[aid], deltas[aid], rewards.get(aid, 0.0), done
                    )
                ep_reward += infos.get(aid, {}).get(
                    "true_reward", rewards.get(aid, 0.0)
                )
            obs = next_obs
        metrics = {}
        for aid in agents:
            if hasattr(agents[aid], "update"):
                metrics[aid] = agents[aid].update()
        history.append({"episode": episode, "reward": ep_reward, **{
            f"{aid}_loss": m.get("actor_loss") for aid, m in metrics.items() if m
        }})
        if log_fn:
            log_fn(episode, history[-1])
        # validation-gated checkpointing after half of training
        # (PPO_backup.py:928-939)
        if save_dir and episode >= num_episodes // 2 and (episode + 1) % val_freq == 0:
            best_reward = validate_and_save_best(env, agents, best_reward, save_dir)
    return history


# -- off-policy loop (SAC_copy.py:157-310) --------------------------------------

def train_off_policy_multi_agent(
    env,
    agents: Dict[str, SACAgent],
    num_episodes: int = 100,
    randomize: bool = False,
    updates_per_step: int = 1,
    warmup_steps: int = 200,
    val_freq: int = 10,
    save_dir: Optional[str] = None,
    log_fn: Optional[Callable[[int, dict], None]] = None,
):
    history = []
    best_reward = -np.inf
    if save_dir:
        # never regress an existing checkpoint: a fresh (possibly worse)
        # training run must beat the previously shipped validation score
        # before it may overwrite save_dir.  Caveat: the stored score was
        # measured on THAT run's validation worlds; on scenarios with
        # unseeded demand (long_corridor) scores are not comparable
        # across runs — scripts/train_zoo.train_sac_batched re-scores the
        # shipped checkpoint under the candidate's exact protocol instead
        cfg_path = os.path.join(save_dir, "config.json")
        if os.path.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    prev = json.load(f).get("extra", {}).get("val_reward")
                if prev is not None:
                    best_reward = float(prev)
            except (json.JSONDecodeError, OSError):
                pass
    total_steps = 0
    for episode in range(num_episodes):
        # off-policy replay tolerates mixed worlds, so keep 1-in-4
        # episodes on the NOMINAL scenario: randomized demand draws are
        # much lighter than nominal, and a buffer with no nominal
        # congestion left the round-2 SAC zoo out of distribution on the
        # paired nominal evaluation runs (docs/RESULTS.md)
        ep_randomize = randomize and (episode % 4 != 3)
        obs, _ = env.reset(options={"randomize": ep_randomize})
        for a in agents.values():
            a.reset_hidden()  # first push below tiles the reset obs
        done = False
        ep_reward = 0.0
        while not done:
            deltas, cur_stacks = {}, {}
            for aid in agents:
                if total_steps < warmup_steps:
                    act_dim = agents[aid].act_dim
                    deltas[aid] = np.random.uniform(
                        -agents[aid].max_delta, agents[aid].max_delta, act_dim
                    ).astype(np.float32)
                    agents[aid]._stack(obs[aid])  # keep the window rolling
                else:
                    deltas[aid] = agents[aid].take_action(obs[aid])
                cur_stacks[aid] = agents[aid].last_stack
            actions = {
                aid: agents[aid].absolute_action(obs[aid], deltas[aid])
                for aid in agents
            }
            next_obs, rewards, terms, truncs, infos = env.step(actions)
            done = any(terms.values()) or any(truncs.values())
            for aid in agents:
                # the stored next state must INCLUDE next_obs (previously
                # the pre-transition stack was stored, so the critic
                # bootstrapped at the state the action was taken from);
                # peek, don't push — take_action pushes next iteration.
                # Deltas are stored RAW: SACAgent.update() normalizes by
                # max_delta itself (double-dividing fed the critic
                # actions in [-0.4, 0.4] while the actor optimized tanh
                # outputs in [-1, 1] — the round-2 zoo's broken SAC).
                next_stack = agents[aid].peek_stack(next_obs[aid])
                agents[aid].store_transition(
                    cur_stacks[aid], deltas[aid],
                    rewards.get(aid, 0.0), next_stack, done,
                )
                ep_reward += infos.get(aid, {}).get(
                    "true_reward", rewards.get(aid, 0.0)
                )
            obs = next_obs
            total_steps += 1
            if total_steps >= warmup_steps:
                for aid in agents:
                    for _ in range(updates_per_step):
                        agents[aid].update()
        history.append({"episode": episode, "reward": ep_reward})
        if log_fn:
            log_fn(episode, history[-1])
        if save_dir and episode >= num_episodes // 2 and (episode + 1) % val_freq == 0:
            best_reward = validate_and_save_best(env, agents, best_reward, save_dir)
    if save_dir:
        # the final state competes too — off-policy training is not
        # monotone, so the shipped checkpoint is whichever validated
        # best, not whatever the last gradient step left behind
        validate_and_save_best(env, agents, best_reward, save_dir)
    return history


# -- data-parallel batched trainer ----------------------------------------------

def init_train_state(core, key):
    """Policy + optimizer state for the batched data-parallel trainer."""
    spec = core.spec
    agent_id = spec.gate_ids[0] if spec.gate_ids else "sep"
    if spec.gate_ids:
        from ..env.agents import FEATURES_PER_LINK

        obs_dim = len(spec.gate_links[0]) * FEATURES_PER_LINK[core.obs_mode]
        act_dim = len(spec.gate_links[0])
    else:
        obs_dim, act_dim = 4, 1
    policy = MLPPolicy(act_dim)
    params = policy.init(key, jnp.zeros(obs_dim))
    tx = optax.adam(3e-4)
    return {
        "agent_id": agent_id,
        "policy": policy,
        "params": params,
        "tx": tx,
        "opt_state": tx.init(params),
        "act_dim": act_dim,
    }


def make_dp_train_step(core, mesh, axis: str = "env"):
    """DEMO ONLY — do not train with this.  One sharded one-step
    REINFORCE update (adv = r - mean r): local replicas step on each
    device; the replicated-params out_sharding makes GSPMD all-reduce
    the gradients over the mesh.  It exists as the smallest-possible
    sharded-update exhibit for the multi-chip dryrun and
    tests/test_parallel.py; the production trainer is
    rl.batched_ppo.BatchedPPOTrainer(mesh=...), which shards the same
    way with a real PPO objective, recurrent policies, and domain
    randomization."""
    spec = core.spec
    batch_sh = NamedSharding(mesh, P(axis))
    repl_sh = NamedSharding(mesh, P())
    policy_holder = {}

    def _default_actions(B):
        actions = {}
        if spec.sep_ids:
            mid = (np.asarray(spec.sep_total_width) / 2).astype(np.float32)
            actions["sep"] = jnp.tile(mid[None], (B, 1))
        for i, gid in enumerate(spec.gate_ids):
            w = np.asarray(spec.gate_link_widths[i], np.float32)
            actions[gid] = jnp.tile(w[None], (B, 1))
        return actions

    def train_step(states, obs, params, opt_state):
        policy = policy_holder["policy"]
        tx = policy_holder["tx"]
        agent_id = policy_holder["agent_id"]
        agent_obs = obs[agent_id] if agent_id in obs else obs["sep"][:, 0]
        B = agent_obs.shape[0]

        def loss_fn(p):
            mu, log_std, _ = jax.vmap(lambda o: policy.apply(p, o))(agent_obs)
            noise = jax.vmap(
                lambda st: jax.random.normal(jax.random.fold_in(st, 0), (mu.shape[1],))
            )(states.key)
            act = mu + jnp.exp(log_std) * noise
            actions = _default_actions(B)
            if agent_id in actions:
                actions[agent_id] = act
            new_states, new_obs, rewards, done, _ = jax.vmap(core._step_impl)(
                states, actions
            )
            r = rewards.get(agent_id, jnp.zeros(B))
            logp = jax.vmap(_gaussian_logprob)(mu, log_std, act)  # log_std batched by vmap
            adv = r - r.mean()
            loss = -(logp * adv).mean()
            return loss, (new_states, new_obs)

        (loss, (new_states, new_obs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return new_states, new_obs, params, opt_state, {"loss": loss}

    jitted = jax.jit(
        train_step,
        in_shardings=(batch_sh, batch_sh, repl_sh, repl_sh),
        out_shardings=(batch_sh, batch_sh, repl_sh, repl_sh, repl_sh),
    )

    def step(states, obs, train_state):
        policy_holder.update(train_state)
        new_states, new_obs, params, opt_state, metrics = jitted(
            states, obs, train_state["params"], train_state["opt_state"]
        )
        train_state = dict(train_state, params=params, opt_state=opt_state)
        return new_states, new_obs, train_state, metrics

    return step


# -- CLI (reference rl/train_rl.py:35-247) ---------------------------------------

def make_logger(log_path: Optional[str] = None, use_wandb: bool = False,
                project: str = "crowd-control-rl"):
    """Episode metric logger: JSONL file, console, optional wandb
    (PPO_backup.py:783-786,913-926)."""
    run = None
    if use_wandb:
        try:
            import wandb

            run = wandb.init(project=project)
        except ImportError:
            print("wandb not installed; falling back to JSONL logging")
    fh = open(log_path, "a") if log_path else None

    def log_fn(episode: int, metrics: dict):
        print(f"episode {episode}: " + ", ".join(
            f"{k}={v:.3f}" for k, v in metrics.items()
            if isinstance(v, (int, float)) and v is not None
        ))
        if fh:
            import json

            fh.write(json.dumps(metrics, default=float) + "\n")
            fh.flush()
        if run:
            run.log(metrics, step=episode)

    return log_fn


def main():
    import argparse

    from ..env import PedNetParallelEnv
    from .rl_utils import RunningNormalizeWrapper

    parser = argparse.ArgumentParser(
        description="Train multi-agent crowd-control policies"
    )
    parser.add_argument("--dataset", default="butterfly_scC")
    parser.add_argument("--algo", default="ppo", choices=["ppo", "sac"])
    parser.add_argument("--net", default="attention",
                        choices=["attention", "lstm", "stacked", "mlp",
                                 "gat", "udlstm"])
    parser.add_argument("--episodes", type=int, default=100)
    parser.add_argument("--obs-mode", default="option2")
    parser.add_argument("--action-gap", type=int, default=15)
    parser.add_argument("--randomize", action="store_true")
    parser.add_argument("--normalize", action="store_true", default=True)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--log-file", default=None)
    args = parser.parse_args()

    env = PedNetParallelEnv(args.dataset, obs_mode=args.obs_mode,
                            seed=args.seed, action_gap=args.action_gap)
    wrapped = RunningNormalizeWrapper(env) if args.normalize else env
    save_dir = args.save_dir or f"outputs/{args.algo}_agents_{args.dataset}"
    log_fn = make_logger(args.log_file, use_wandb=args.wandb)

    if args.algo == "ppo":
        agents = build_agents(env, algo="ppo", net_type=args.net, seed=args.seed)
        train_on_policy_multi_agent(wrapped, agents, num_episodes=args.episodes,
                                    randomize=args.randomize,
                                    save_dir=save_dir, log_fn=log_fn)
    else:
        agents = build_agents(env, algo="sac", seed=args.seed)
        train_off_policy_multi_agent(wrapped, agents, num_episodes=args.episodes,
                                     randomize=args.randomize,
                                     save_dir=save_dir, log_fn=log_fn)
    from .rl_utils import save_all_agents

    save_all_agents(agents, save_dir, env=wrapped)
    print(f"saved agents to {save_dir}")


if __name__ == "__main__":
    main()
