"""Batched SAC: vectorized collection + scanned updates.

The reference trains SAC through a per-episode host loop
(rl/agents/SAC_copy.py:157-310) — one environment, one gradient step
per RL step, a few thousand updates per training run.  That budget
underfits the bundled scenarios (the round-2/3 zoo's weak SAC rows).
Here B lockstep env replicas collect transitions into a device-resident
replay buffer and a scan of update steps trains on minibatches, all in
ONE jitted program per iteration, so a competent SAC budget (1e5+
gradient steps) costs minutes instead of hours.

Semantics mirror the host SACAgent exactly (twin-Q, tanh-squashed
Gaussian over a frame-stacked window, auto-entropy via log_alpha, soft
target updates — SAC_copy.py:313-482) and the RunningNormalizeWrapper
pipeline (rl_utils.py:86-300): per-agent running obs normalization that
skips the gate-width feature, and reward normalization by the running
std of discounted returns.  Checkpoints export in the host format
({agent_id}.pkl + config.json + norm_stats.json), so the existing
evaluation harness loads them unchanged.

Independent learners: every gate agent and every separator agent owns
its own actor/critic/alpha, as in the reference.

Usage:
    trainer = BatchedSACTrainer(env.core, num_envs=64, randomize=True)
    state = trainer.init(jax.random.PRNGKey(0))
    for it in range(200):
        state, metrics = trainer.train_iteration(state)
    trainer.export(state, "artifacts/zoo/sac_agents_x", extra={...})
"""

from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp
import optax

from ..env.agents import FEATURES_PER_LINK
from ..env.core import PedNetEnvCore
from ..pytree import pytree_dataclass
from ..randomize import randomize_engine_params
from .networks import SACActor, SACCritic


@pytree_dataclass
class SACTrainerState:
    env_states: object
    obs: Dict[str, jnp.ndarray]          # raw per-agent obs [B, obs_dim]
    stacks: Dict[str, jnp.ndarray]       # normalized frame stacks [B, S, obs_dim]
    params: Dict[str, Dict[str, object]]  # per agent: actor/critic/target/log_alpha
    opt_states: Dict[str, Dict[str, object]]
    rms: Dict[str, Dict[str, jnp.ndarray]]  # obs mean/var/count + ret mean/var/count
    returns: Dict[str, jnp.ndarray]      # discounted return accumulators [B]
    buffers: Dict[str, Dict[str, jnp.ndarray]]
    ptr: jnp.ndarray                     # shared ring pointer (lockstep writes)
    size: jnp.ndarray
    engine_params: object                # batched EngineParams when randomize
    key: jax.Array
    iteration: jnp.ndarray


def _where_done(done, fresh, cur):
    return jax.tree_util.tree_map(
        lambda f, c: jnp.where(done.reshape((-1,) + (1,) * (c.ndim - 1)), f, c),
        fresh, cur,
    )


class BatchedSACTrainer:
    def __init__(
        self,
        core: PedNetEnvCore,
        num_envs: int = 64,
        collect_steps: int = 8,
        updates_per_iter: int = 32,
        batch_size: int = 256,
        buffer_capacity: int = 65536,
        stack_size: int = 4,
        hidden_dim: int = 64,
        actor_lr: float = 3e-4,
        critic_lr: float = 3e-4,
        alpha_lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        max_delta: float = 2.5,
        warmup_transitions: int = 1024,
        clip_obs: float = 10.0,
        clip_reward: float = 10.0,
        randomize: bool = False,
        randomize_fraction: float = 1.0,
        gate_anchor: str = "open",
        mesh=None,
    ):
        if gate_anchor not in ("current", "open"):
            raise ValueError("gate_anchor must be 'current' or 'open'")
        self.core = core
        self.scn = core.scn
        self.spec = core.spec
        self.B = num_envs
        self.C = collect_steps
        self.U = updates_per_iter
        self.batch_size = batch_size
        self.cap = buffer_capacity
        self.S = stack_size
        self.hidden_dim = hidden_dim
        self.gamma = gamma
        self.tau = tau
        self.max_delta = max_delta
        self.warmup = warmup_transitions
        self.clip_obs = clip_obs
        self.clip_reward = clip_reward
        self.randomize = randomize
        self.randomize_fraction = randomize_fraction
        self.gate_anchor = gate_anchor
        self.mesh = mesh

        fpl = FEATURES_PER_LINK[core.obs_mode]
        # independent learners keyed by ENV agent id (host parity:
        # rl.train.build_agents makes one SACAgent per spec.agent_ids
        # entry), so exported checkpoints are 1:1 with the host format
        self.agents: Dict[str, dict] = {}
        for i, gid in enumerate(self.spec.gate_ids):
            L = len(self.spec.gate_links[i])
            mask = np.ones(L * fpl, bool)
            # the gate-width feature stays raw (rl_utils.py:129-141)
            mask.reshape(L, fpl)[:, -1] = False
            self.agents[gid] = {
                "obs_dim": L * fpl, "act_dim": L, "kind": "gate",
                "index": i, "norm_mask": mask,
                "low": np.zeros(L, np.float32),
                "high": np.asarray(self.spec.gate_link_widths[i], np.float32),
            }
        for i, sid in enumerate(self.spec.sep_ids):
            lo = float(self.spec.min_sep_width)
            hi = float(self.spec.sep_total_width[i]) - lo
            self.agents[sid] = {
                "obs_dim": 4, "act_dim": 1, "kind": "sep", "index": i,
                "norm_mask": np.ones(4, bool),
                "low": np.asarray([lo], np.float32),
                "high": np.asarray([hi], np.float32),
            }

        self.actor = {aid: SACActor(m["act_dim"], hidden_dim)
                      for aid, m in self.agents.items()}
        self.critic = SACCritic(hidden_dim)
        self.actor_tx = optax.adam(actor_lr)
        self.critic_tx = optax.adam(critic_lr)
        self.alpha_tx = optax.adam(alpha_lr)
        self._train_iter = jax.jit(self._train_iteration_impl)

    # -- mesh sharding (trainer-owned, as BatchedPPOTrainer) ---------------------

    def _shard_spec(self, batched: bool):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P("env") if batched else P())

    def _place(self, tree, batched: bool = True):
        """Host-side placement: replica-axis leaves shard over the mesh's
        ``env`` axis; params/opt/rms/replay buffers replicate (the buffer
        leading axis is the ring capacity, not the batch)."""
        if self.mesh is None or tree is None:
            return tree
        sh_b = self._shard_spec(True)
        sh_r = self._shard_spec(False)

        def put(x):
            x = jnp.asarray(x)
            if batched and x.ndim >= 1 and x.shape[0] == self.B:
                return jax.device_put(x, sh_b)
            return jax.device_put(x, sh_r)

        return jax.tree_util.tree_map(put, tree)

    def _constrain(self, tree, batched: bool = True):
        if self.mesh is None or tree is None:
            return tree
        sh_b = self._shard_spec(True)
        sh_r = self._shard_spec(False)

        def con(x):
            x = jnp.asarray(x)
            if batched and x.ndim >= 1 and x.shape[0] == self.B:
                return jax.lax.with_sharding_constraint(x, sh_b)
            return jax.lax.with_sharding_constraint(x, sh_r)

        return jax.tree_util.tree_map(con, tree)

    # -- setup -------------------------------------------------------------------

    def init(self, key: jax.Array) -> SACTrainerState:
        key, k_env, k_rand, *aks = jax.random.split(key, 3 + 2 * len(self.agents))
        env_states, obs_env = self.core.batch_reset(jax.random.split(k_env, self.B))
        eps = None
        if self.randomize:
            eps = jax.vmap(lambda k: randomize_engine_params(self.scn, k))(
                jax.random.split(k_rand, self.B)
            )
            eps = self._mix_nominal(eps)
        params, opts, rms, rets, stacks, bufs = {}, {}, {}, {}, {}, {}
        obs_raw = {aid: self._agent_obs(obs_env, aid) for aid in self.agents}
        for (aid, meta), k1, k2 in zip(self.agents.items(),
                                       aks[: len(self.agents)],
                                       aks[len(self.agents):]):
            dummy_o = jnp.zeros((self.S, meta["obs_dim"]))
            dummy_a = jnp.zeros((meta["act_dim"],))
            ap = self.actor[aid].init(k1, dummy_o)
            cp = self.critic.init(k2, dummy_o, dummy_a)
            params[aid] = {"actor": ap, "critic": cp, "target": cp,
                           "log_alpha": jnp.zeros(())}
            opts[aid] = {"actor": self.actor_tx.init(ap),
                         "critic": self.critic_tx.init(cp),
                         "alpha": self.alpha_tx.init(jnp.zeros(()))}
            rms[aid] = {
                "obs_mean": jnp.zeros(meta["obs_dim"]),
                "obs_var": jnp.ones(meta["obs_dim"]),
                "obs_count": jnp.asarray(1e-4),
                "ret_mean": jnp.zeros(()),
                "ret_var": jnp.ones(()),
                "ret_count": jnp.asarray(1e-4),
            }
            rets[aid] = jnp.zeros(self.B)
            o0 = self._normalize(aid, rms[aid], obs_raw[aid])
            stacks[aid] = jnp.tile(o0[:, None, :], (1, self.S, 1))
            bufs[aid] = {
                "s": jnp.zeros((self.cap, self.S, meta["obs_dim"])),
                "a": jnp.zeros((self.cap, meta["act_dim"])),
                "r": jnp.zeros((self.cap,)),
                "ns": jnp.zeros((self.cap, self.S, meta["obs_dim"])),
                "d": jnp.zeros((self.cap,)),
            }
        if self.mesh is not None:
            env_states = self._place(env_states)
            obs_raw = self._place(obs_raw)
            stacks = self._place(stacks)
            rets = self._place(rets)
            eps = self._place(eps)
            params = self._place(params, batched=False)
            opts = self._place(opts, batched=False)
            rms = self._place(rms, batched=False)
            bufs = self._place(bufs, batched=False)
        return SACTrainerState(
            env_states=env_states, obs=obs_raw, stacks=stacks, params=params,
            opt_states=opts, rms=rms, returns=rets, buffers=bufs,
            ptr=jnp.asarray(0, jnp.int32), size=jnp.asarray(0, jnp.int32),
            engine_params=eps, key=key, iteration=jnp.asarray(0),
        )

    # -- helpers -----------------------------------------------------------------

    def _mix_nominal(self, eps):
        if self.randomize_fraction >= 1.0:
            return eps
        n_rand = int(round(self.randomize_fraction * self.B))
        is_rand = jnp.arange(self.B) < n_rand
        nominal = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (self.B,) + jnp.asarray(x).shape),
            self.scn.engine_params,
        )
        return _where_done(is_rand, eps, nominal)

    def _agent_obs(self, obs_env, aid):
        meta = self.agents[aid]
        if meta["kind"] == "sep":
            return obs_env["sep"][:, meta["index"], :]
        return obs_env[aid]

    def _normalize(self, aid, rms_a, o_raw):
        """Running-normalize [B, obs_dim] obs, skipping the gate-width
        feature (rl_utils.py:113-132 semantics)."""
        mask = jnp.asarray(self.agents[aid]["norm_mask"])
        normed = (o_raw - rms_a["obs_mean"]) / jnp.sqrt(rms_a["obs_var"] + 1e-8)
        normed = jnp.clip(normed, -self.clip_obs, self.clip_obs)
        return jnp.where(mask[None, :], normed, o_raw).astype(jnp.float32)

    @staticmethod
    def _rms_update(mean, var, count, batch):
        """Chan parallel update with a [B, ...] batch (the host wrapper
        feeds one sample per call; feeding the whole replica batch keeps
        identical semantics at B x the rate)."""
        b_mean = batch.mean(axis=0)
        b_var = batch.var(axis=0)
        b_count = batch.shape[0]
        delta = b_mean - mean
        tot = count + b_count
        new_mean = mean + delta * b_count / tot
        m_a = var * count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * count * b_count / tot
        return new_mean, m2 / tot, tot

    def _absolute(self, aid, o_raw, delta):
        meta = self.agents[aid]
        if meta["kind"] == "sep":
            cur = (meta["low"] + meta["high"]) / 2.0
            cur = jnp.broadcast_to(cur, delta.shape)
        elif self.gate_anchor == "open":
            cur = jnp.broadcast_to(meta["high"], delta.shape)
        else:  # reference integrator semantics: anchor at current width
            cur = o_raw.reshape(o_raw.shape[0], meta["act_dim"], -1)[:, :, -1]
        return jnp.clip(cur + delta, meta["low"], meta["high"])

    # -- collection --------------------------------------------------------------

    def _env_step(self, env_states, env_actions, eps):
        t0 = env_states.t[0]
        if self.randomize:
            return jax.vmap(
                lambda s, a, e: self.core._step_impl(s, a, e, t_shared=t0)
            )(env_states, env_actions, eps)
        return jax.vmap(
            lambda s, a: self.core._step_impl(s, a, t_shared=t0)
        )(env_states, env_actions)

    def _collect(self, ts: SACTrainerState, key):
        nsep = len(self.spec.sep_ids)

        def step(carry, k):
            env_states, obs, stacks, rms, rets, bufs, ptr, size, eps = carry
            deltas, abs_acts = {}, {}
            for ai, aid in enumerate(self.agents):
                k_a = jax.random.fold_in(k, ai)
                a, _ = jax.vmap(
                    lambda s, kk: self.actor[aid].sample(
                        ts.params[aid]["actor"], s, kk)
                )(stacks[aid], jax.random.split(k_a, self.B))
                delta = a * self.max_delta
                deltas[aid] = a  # buffer stores the [-1, 1] pre-scale action
                abs_acts[aid] = self._absolute(aid, obs[aid], delta)
            env_actions = {aid: abs_acts[aid] for aid in self.agents
                           if self.agents[aid]["kind"] == "gate"}
            if nsep:
                env_actions["sep"] = jnp.concatenate(
                    [abs_acts[sid] for sid in self.spec.sep_ids], axis=-1
                )
            new_states, new_obs_env, rewards, done, _ = self._env_step(
                env_states, env_actions, eps
            )
            new_obs = {aid: self._agent_obs(new_obs_env, aid)
                       for aid in self.agents}

            idx = jnp.mod(ptr + jnp.arange(self.B), self.cap)
            new_stacks, new_rms, new_rets, new_bufs = {}, {}, {}, {}
            for aid in self.agents:
                rms_a = dict(rms[aid])
                m, v, c = self._rms_update(
                    rms_a["obs_mean"], rms_a["obs_var"], rms_a["obs_count"],
                    new_obs[aid])
                rms_a.update(obs_mean=m, obs_var=v, obs_count=c)
                o_n = self._normalize(aid, rms_a, new_obs[aid])
                next_stack = jnp.concatenate(
                    [stacks[aid][:, 1:], o_n[:, None, :]], axis=1)

                r_true = rewards.get(aid, jnp.zeros(self.B))
                ret = rets[aid] * self.gamma + r_true
                rm, rv, rc = self._rms_update(
                    rms_a["ret_mean"], rms_a["ret_var"], rms_a["ret_count"],
                    ret[:, None])
                rms_a.update(ret_mean=rm[0], ret_var=rv[0], ret_count=rc)
                r_n = jnp.clip(r_true / jnp.sqrt(rms_a["ret_var"] + 1e-8),
                               -self.clip_reward, self.clip_reward)

                b = bufs[aid]
                new_bufs[aid] = {
                    "s": b["s"].at[idx].set(stacks[aid]),
                    "a": b["a"].at[idx].set(deltas[aid]),
                    "r": b["r"].at[idx].set(r_n),
                    "ns": b["ns"].at[idx].set(next_stack),
                    "d": b["d"].at[idx].set(done.astype(jnp.float32)),
                }
                new_rms[aid] = rms_a
                new_rets[aid] = ret * (1.0 - done.astype(jnp.float32))
                new_stacks[aid] = next_stack

            # auto-reset finished replicas: fresh engine state, fresh
            # stacks anchored at the fresh obs, fresh world draws
            reset_keys = jax.vmap(lambda s: jax.random.fold_in(s, 7))(new_states.key)
            fresh = jax.vmap(self.core.scn.init_state)(reset_keys)
            new_states = _where_done(done, fresh, new_states)
            if self.randomize:
                def _redraw(eps_in):
                    redraw = jax.vmap(
                        lambda kk: randomize_engine_params(self.scn, kk)
                    )(jax.vmap(lambda s: jax.random.fold_in(s, 13))(new_states.key))
                    return _where_done(done, self._mix_nominal(redraw), eps_in)

                # gate on ANY replica finishing, not just replica 0:
                # correct under today's time-based lockstep done (all
                # flags flip together), and still correct if termination
                # ever becomes per-replica (_where_done selects per row)
                eps = jax.lax.cond(jnp.any(done), _redraw, lambda e: e, eps)
            fresh_obs_env = jax.vmap(self.core._observations)(new_states)
            for aid in self.agents:
                fo = self._agent_obs(fresh_obs_env, aid)
                new_obs[aid] = jnp.where(done[:, None], fo, new_obs[aid])
                fo_n = self._normalize(aid, new_rms[aid], fo)
                fresh_stack = jnp.tile(fo_n[:, None, :], (1, self.S, 1))
                new_stacks[aid] = _where_done(done, fresh_stack, new_stacks[aid])

            mean_r = sum(rewards.get(a, jnp.zeros(self.B)).mean()
                         for a in self.agents) / len(self.agents)
            carry = (new_states, new_obs, new_stacks, new_rms, new_rets,
                     new_bufs, jnp.mod(ptr + self.B, self.cap),
                     jnp.minimum(size + self.B, self.cap), eps)
            return carry, mean_r

        carry0 = (ts.env_states, ts.obs, ts.stacks, ts.rms, ts.returns,
                  ts.buffers, ts.ptr, ts.size, ts.engine_params)
        carry, step_rewards = jax.lax.scan(
            step, carry0, jax.random.split(key, self.C))
        return carry, step_rewards.mean()

    # -- update ------------------------------------------------------------------

    def _sac_update(self, aid, p, opt, batch, key):
        """One SAC gradient step — identical math to SACAgent._update_step
        (sac.py:153-197, SAC_copy.py:382-420)."""
        s, a, r, ns, d = batch
        k1, k2 = jax.random.split(key)
        actor = self.actor[aid]
        alpha = jnp.exp(p["log_alpha"])
        target_entropy = -float(self.agents[aid]["act_dim"])

        na, nlogp = jax.vmap(lambda o, k: actor.sample(p["actor"], o, k))(
            ns, jax.random.split(k1, s.shape[0]))
        q1t, q2t = jax.vmap(lambda o, act: self.critic.apply(p["target"], o, act))(ns, na)
        target_q = r + self.gamma * (1 - d) * (jnp.minimum(q1t, q2t) - alpha * nlogp)

        def critic_loss(cp):
            q1, q2 = jax.vmap(lambda o, act: self.critic.apply(cp, o, act))(s, a)
            return ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()

        c_loss, c_grads = jax.value_and_grad(critic_loss)(p["critic"])
        c_up, opt_c = self.critic_tx.update(c_grads, opt["critic"])
        critic_params = optax.apply_updates(p["critic"], c_up)

        def actor_loss(ap):
            aa, logp = jax.vmap(lambda o, k: actor.sample(ap, o, k))(
                s, jax.random.split(k2, s.shape[0]))
            q1, q2 = jax.vmap(
                lambda o, act: self.critic.apply(critic_params, o, act))(s, aa)
            return (alpha * logp - jnp.minimum(q1, q2)).mean(), logp

        (a_loss, logp), a_grads = jax.value_and_grad(
            actor_loss, has_aux=True)(p["actor"])
        a_up, opt_a = self.actor_tx.update(a_grads, opt["actor"])
        actor_params = optax.apply_updates(p["actor"], a_up)

        def alpha_loss(la):
            return (-jnp.exp(la) * (logp + target_entropy)).mean()

        al_loss, al_grad = jax.value_and_grad(alpha_loss)(p["log_alpha"])
        al_up, opt_al = self.alpha_tx.update(al_grad, opt["alpha"])
        log_alpha = optax.apply_updates(p["log_alpha"], al_up)

        target_params = jax.tree_util.tree_map(
            lambda t, s_: (1 - self.tau) * t + self.tau * s_,
            p["target"], critic_params)
        return ({"actor": actor_params, "critic": critic_params,
                 "target": target_params, "log_alpha": log_alpha},
                {"actor": opt_a, "critic": opt_c, "alpha": opt_al},
                a_loss, c_loss)

    def _train_iteration_impl(self, ts: SACTrainerState):
        if self.mesh is not None:
            # the trainer owns the layout: re-assert inside jit so callers
            # passing unsharded state still train sharded (PPO parity)
            ts = ts.replace(
                env_states=self._constrain(ts.env_states),
                obs=self._constrain(ts.obs),
                stacks=self._constrain(ts.stacks),
                returns=self._constrain(ts.returns),
                engine_params=self._constrain(ts.engine_params),
                params=self._constrain(ts.params, batched=False),
                opt_states=self._constrain(ts.opt_states, batched=False),
                rms=self._constrain(ts.rms, batched=False),
                buffers=self._constrain(ts.buffers, batched=False),
            )
        key, k_col, k_upd = jax.random.split(ts.key, 3)
        (env_states, obs, stacks, rms, rets, bufs, ptr, size, eps), mean_r = \
            self._collect(ts, k_col)

        # scanned update steps; no-ops until the buffer holds warmup
        # transitions (host-loop warmup_steps analog)
        ready = size >= min(self.warmup, self.cap)
        metrics = {"reward": mean_r, "buffer_size": size.astype(jnp.float32)}
        new_params, new_opts = dict(ts.params), dict(ts.opt_states)
        for ai, aid in enumerate(self.agents):
            def upd(carry, k):
                p, opt = carry
                ks, ku = jax.random.split(k)
                idx = jax.random.randint(ks, (self.batch_size,), 0,
                                         jnp.maximum(size, 1))
                b = bufs[aid]
                batch = (b["s"][idx], b["a"][idx], b["r"][idx],
                         b["ns"][idx], b["d"][idx])
                p2, opt2, a_loss, c_loss = self._sac_update(aid, p, opt, batch, ku)
                p = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(ready, new, old), p2, p)
                opt = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(ready, new, old), opt2, opt)
                return (p, opt), (a_loss, c_loss)

            (p, opt), (a_losses, c_losses) = jax.lax.scan(
                upd, (ts.params[aid], ts.opt_states[aid]),
                jax.random.split(jax.random.fold_in(k_upd, ai), self.U))
            new_params[aid] = p
            new_opts[aid] = opt
            metrics[f"{aid}/actor_loss"] = a_losses.mean()
            metrics[f"{aid}/critic_loss"] = c_losses.mean()
            metrics[f"{aid}/alpha"] = jnp.exp(p["log_alpha"])

        new_ts = SACTrainerState(
            env_states=env_states, obs=obs, stacks=stacks, params=new_params,
            opt_states=new_opts, rms=rms, returns=rets, buffers=bufs,
            ptr=ptr, size=size, engine_params=eps, key=key,
            iteration=ts.iteration + 1,
        )
        return new_ts, metrics

    def train_iteration(self, ts: SACTrainerState):
        ts, metrics = self._train_iter(ts)
        return ts, {k: float(v) for k, v in metrics.items()}

    # -- persistence --------------------------------------------------------------

    def agent_config(self, aid: str) -> dict:
        meta = self.agents[aid]
        return {"obs_dim": meta["obs_dim"], "act_dim": meta["act_dim"],
                "stack_size": self.S, "gamma": self.gamma, "tau": self.tau,
                "max_delta": self.max_delta, "gate_anchor": self.gate_anchor,
                "algo": "sac"}

    def export(self, ts: SACTrainerState, save_dir: str,
               extra: Optional[dict] = None):
        """Write host-format checkpoints: {agent_id}.pkl (SACAgent.save
        layout), config.json (save_all_agents layout), norm_stats.json
        (RunningNormalizeWrapper.save_stats layout) — so build_agents +
        load_all_agents + the eval harness work unchanged."""
        import json
        import os
        import pickle

        os.makedirs(save_dir, exist_ok=True)
        for aid in self.agents:
            p = jax.device_get(ts.params[aid])
            with open(os.path.join(save_dir, f"{aid}.pkl"), "wb") as f:
                pickle.dump({
                    "config": self.agent_config(aid),
                    "actor": p["actor"],
                    "critic": p["critic"],
                    "target_critic": p["target"],
                    "log_alpha": float(p["log_alpha"]),
                }, f)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump({"agents": {aid: self.agent_config(aid)
                                  for aid in self.agents},
                       "extra": extra or {}}, f, indent=2, default=str)
        stats = {"obs_rms": {}, "ret_rms": {}}
        for aid in self.agents:
            r = jax.device_get(ts.rms[aid])
            stats["obs_rms"][aid] = {
                "mean": np.asarray(r["obs_mean"]).tolist(),
                "var": np.asarray(r["obs_var"]).tolist(),
                "count": float(r["obs_count"]),
            }
            stats["ret_rms"][aid] = {
                "mean": float(r["ret_mean"]),
                "var": float(r["ret_var"]),
                "count": float(r["ret_count"]),
            }
        with open(os.path.join(save_dir, "norm_stats.json"), "w") as f:
            json.dump(stats, f)
