"""Batched PPO: vectorized rollouts + updates, one XLA program.

The reference scales rollouts with Ray worker processes
(train_ppo_rllib.py:62-64) and trains its default attention-LSTM policy
(PPO_backup.py:597-760,1098-1101) through a per-episode host loop.  Here
B env replicas roll T steps inside a single jitted scan — engine,
recurrent policy torsos, and value nets fused — GAE is computed over the
[T, B] batch, and every agent's PPO update re-forwards full sequences
through the recurrent torso, minibatched over the replica axis, with
clipped surrogate + entropy bonus + approximate-KL early stop
(PPO_backup.py:1247-1389 semantics).  Independent learners, as in the
reference: each agent has its own policy/value parameters.

Policy families (``net_type``):
  * ``mlp``       — feedforward (fast smoke-test baseline)
  * ``attention`` — per-link LSTM + all-to-all link attention for gate
                    agents (the reference default), flat LSTM for the
                    separator pseudo-agent (mirrors rl.train.build_agents)
  * ``lstm``      — flat-observation LSTM for every agent

Recurrent state is carried through the rollout scan and across
iterations (truncated-BPTT at the rollout boundary); replicas that hit
the horizon auto-reset state AND hidden carry.  With ``randomize=True``
every replica simulates its own randomized world (EngineParams drawn by
pednstream_tpu.randomize) and re-draws it at each episode boundary —
the batched analog of the reference's per-episode domain randomization
(env_loader.py:160-181).

Usage:
    trainer = BatchedPPOTrainer(env.core, num_envs=256, rollout_len=32,
                                net_type="attention", randomize=True)
    state = trainer.init(jax.random.PRNGKey(0))
    for it in range(100):
        state, metrics = trainer.train_iteration(state)

The init key is a threefry key (the default).
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
from .networks import (
    AttentionPolicy,
    AttentionTorso,
    AttentionValue,
    LSTMPolicy,
    LSTMValue,
    MLPPolicy,
    MLPValue,
)
from .ppo import _gaussian_logprob


@pytree_dataclass
class TrainerState:
    env_states: object
    obs: Dict[str, jnp.ndarray]
    params: Dict[str, object]
    value_params: Dict[str, object]
    opt_states: Dict[str, object]
    actor_carry: Dict[str, object]  # [B, ...] recurrent state per agent
    critic_carry: Dict[str, object]
    engine_params: object  # batched EngineParams when randomize=True, else None
    key: jax.Array
    iteration: jnp.ndarray


def _where_done(done, fresh, cur):
    return jax.tree_util.tree_map(
        lambda f, c: jnp.where(done.reshape((-1,) + (1,) * (c.ndim - 1)), f, c),
        fresh, cur,
    )


class BatchedPPOTrainer:
    def __init__(
        self,
        core: PedNetEnvCore,
        num_envs: int = 256,
        rollout_len: int = 32,
        lr: float = 3e-4,
        gamma: float = 0.99,
        lmbda: float = 0.95,
        eps_clip: float = 0.2,
        epochs: int = 4,
        minibatches: int = 4,
        max_delta: float = 2.5,
        entropy_coef: float = 1e-3,
        value_coef: float = 0.5,
        kl_target: float = 0.02,
        reward_scale: float = 1e-2,
        net_type: str = "mlp",
        hidden_dim: int = 64,
        randomize: bool = False,
        randomize_fraction: float = 1.0,
        mesh=None,
        gate_anchor: str = "current",
    ):
        if gate_anchor not in ("current", "open"):
            raise ValueError("gate_anchor must be 'current' or 'open'")
        self.gate_anchor = gate_anchor
        if num_envs % minibatches:
            raise ValueError("num_envs must divide evenly into minibatches")
        self.core = core
        self.scn = core.scn
        self.spec = core.spec
        self.B = num_envs
        self.T = rollout_len
        self.gamma = gamma
        self.lmbda = lmbda
        self.eps_clip = eps_clip
        self.epochs = epochs
        self.minibatches = minibatches
        self.max_delta = max_delta
        self.entropy_coef = entropy_coef
        self.value_coef = value_coef
        self.kl_target = kl_target
        self.reward_scale = reward_scale  # rewards are large negative travel-time sums
        self.net_type = net_type
        self.hidden_dim = hidden_dim
        self.randomize = randomize
        # fraction of replicas simulating randomized worlds; the rest keep
        # the scenario's NOMINAL world so the policy also trains on the
        # regime evaluation runs use (the reference trains randomized-only
        # and its randomized demand is much lighter than nominal — a
        # policy trained that way never sees nominal congestion)
        self.randomize_fraction = randomize_fraction
        self.mesh = mesh

        fpl = FEATURES_PER_LINK[core.obs_mode]
        self.agents = {}
        for i, gid in enumerate(self.spec.gate_ids):
            L = len(self.spec.gate_links[i])
            self.agents[gid] = {
                "obs_dim": L * fpl, "act_dim": L, "fpl": fpl,
                "low": np.zeros(L, np.float32),
                "high": np.asarray(self.spec.gate_link_widths[i], np.float32),
            }
        if self.spec.sep_ids:
            self.agents["sep"] = {
                "obs_dim": 4 * len(self.spec.sep_ids),
                "act_dim": len(self.spec.sep_ids), "fpl": None,
                "low": np.full(len(self.spec.sep_ids),
                               self.spec.min_sep_width, np.float32),
                "high": (np.asarray(self.spec.sep_total_width, np.float32)
                         - self.spec.min_sep_width),
            }
        self.tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(lr))
        self._train_iter = jax.jit(self._train_iteration_impl)

    # -- mesh sharding -----------------------------------------------------------

    def _shard_spec(self, batched: bool):
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P("env") if batched else P())

    def _place(self, tree, batched: bool = True):
        """Host-side placement (init): batch-axis leaves shard over the
        mesh's ``env`` axis, everything else replicates."""
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
        """In-jit sharding constraints so the TRAINER (not the caller)
        establishes the layout: replica-axis leaves shard over ``env``,
        params/optimizer state replicate, and GSPMD propagates through
        the rollout scan and minibatch updates.  No-op without a mesh."""
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

    # -- network families --------------------------------------------------------

    def _family(self, aid: str) -> str:
        """Gate agents get the selected family; the separator pseudo-agent
        gets a flat LSTM under per-link families (mirrors
        rl.train.build_agents, reference train_rl.py:70-95)."""
        if self.net_type in ("attention", "udlstm"):
            return self.net_type if self.agents[aid]["fpl"] else "lstm"
        return self.net_type

    def _nets(self, aid: str):
        fam = self._family(aid)
        meta = self.agents[aid]
        if fam == "attention":
            return (AttentionPolicy(meta["act_dim"], self.hidden_dim),
                    AttentionValue(meta["act_dim"], self.hidden_dim))
        if fam == "udlstm":
            from .networks import UDLSTMPolicy, UDLSTMValue

            return (UDLSTMPolicy(meta["act_dim"], self.hidden_dim),
                    UDLSTMValue(meta["act_dim"], self.hidden_dim))
        if fam == "lstm":
            return (LSTMPolicy(meta["act_dim"], self.hidden_dim),
                    LSTMValue(self.hidden_dim))
        return MLPPolicy(meta["act_dim"]), MLPValue()

    def _init_carry(self, aid: str):
        fam = self._family(aid)
        key = jax.random.PRNGKey(0)  # zeros for OptimizedLSTMCell
        if fam in ("attention", "udlstm"):
            return AttentionTorso.initial_carry(
                key, self.agents[aid]["act_dim"], self.hidden_dim)
        if fam == "lstm":
            return LSTMPolicy.initial_carry(key, self.hidden_dim)
        return jnp.zeros(())

    def _batched_carry(self, aid: str, B: Optional[int] = None):
        B = B or self.B
        c = self._init_carry(aid)
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (B,) + x.shape), c
        )

    def _shape_obs(self, aid: str, o: jnp.ndarray) -> jnp.ndarray:
        """[B, obs_dim] -> [B, L, fpl] for per-link torsos."""
        if self._family(aid) in ("attention", "udlstm"):
            meta = self.agents[aid]
            return o.reshape(o.shape[0], meta["act_dim"], meta["fpl"])
        return o

    # -- setup -----------------------------------------------------------------

    def init(self, key: jax.Array) -> TrainerState:
        key, k_env, k_rand, *aks = jax.random.split(key, 3 + 2 * len(self.agents))
        env_states, obs = self.core.batch_reset(jax.random.split(k_env, self.B))
        eps = None
        if self.randomize:
            eps = jax.vmap(lambda k: randomize_engine_params(self.scn, k))(
                jax.random.split(k_rand, self.B)
            )
            eps = self._mix_nominal(eps)
        params, vparams, opts, acar, ccar = {}, {}, {}, {}, {}
        for (aid, meta), kp, kv in zip(self.agents.items(),
                                       aks[: len(self.agents)],
                                       aks[len(self.agents):]):
            policy, value = self._nets(aid)
            dummy = self._shape_obs(aid, jnp.zeros((1, meta["obs_dim"])))[0]
            c0 = self._init_carry(aid)
            p = policy.init(kp, dummy, c0)
            v = value.init(kv, dummy, c0)
            params[aid] = p
            vparams[aid] = v
            opts[aid] = self.tx.init({"p": p, "v": v})
            acar[aid] = self._batched_carry(aid)
            ccar[aid] = self._batched_carry(aid)
        if self.mesh is not None:
            # the trainer owns the layout: batch-axis state shards over
            # the mesh's env axis, parameters/optimizer state replicate
            env_states = self._place(env_states)
            obs = self._place(obs)
            eps = self._place(eps)
            acar = self._place(acar)
            ccar = self._place(ccar)
            params = self._place(params, batched=False)
            vparams = self._place(vparams, batched=False)
            opts = self._place(opts, batched=False)
        return TrainerState(env_states=env_states, obs=obs, params=params,
                            value_params=vparams, opt_states=opts,
                            actor_carry=acar, critic_carry=ccar,
                            engine_params=eps, key=key,
                            iteration=jnp.asarray(0))

    # -- helpers -----------------------------------------------------------------

    def _mix_nominal(self, eps):
        """Keep replicas [frac*B:] on the nominal EngineParams."""
        if self.randomize_fraction >= 1.0:
            return eps
        n_rand = int(round(self.randomize_fraction * self.B))
        is_rand = jnp.arange(self.B) < n_rand
        nominal = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(jnp.asarray(x), (self.B,) + jnp.asarray(x).shape),
            self.scn.engine_params,
        )
        return _where_done(is_rand, eps, nominal)

    def _agent_obs(self, obs, aid):
        if aid == "sep":
            return obs["sep"].reshape(obs["sep"].shape[0], -1)
        return obs[aid]

    def _absolute(self, aid, obs_a, delta):
        meta = self.agents[aid]
        if meta["fpl"] and self.gate_anchor == "current":
            # reference semantics: delta from the current width (the last
            # feature per link) — an INTEGRATOR: width follows a random
            # walk under an imperfect policy, which drifts gates shut on
            # out-of-distribution demand (PPO_backup.py:848-851)
            cur = obs_a.reshape(obs_a.shape[0], meta["act_dim"], -1)[:, :, -1]
        elif meta["fpl"]:
            # 'open' anchor: absolute target = full-open + learned
            # offset.  Integrator-free — a zero-output policy IS the
            # no-control policy, so training explores around the sane
            # baseline instead of around closure drift; the env's rate
            # limiter still applies the reference's actuation dynamics.
            cur = jnp.broadcast_to(meta["high"], delta.shape)
        else:  # separator: target is absolute width around the midpoint
            cur = (meta["low"] + meta["high"]) / 2
            cur = jnp.broadcast_to(cur, delta.shape)
        return jnp.clip(cur + delta, meta["low"], meta["high"])

    def _policy(self, aid):
        return self._nets(aid)[0]

    def _apply_policy(self, aid, params, obs_b, carry_b):
        policy = self._nets(aid)[0]
        return jax.vmap(lambda o, c: policy.apply(params, o, c))(obs_b, carry_b)

    def _apply_value(self, aid, vparams, obs_b, carry_b):
        value = self._nets(aid)[1]
        return jax.vmap(lambda o, c: value.apply(vparams, o, c))(obs_b, carry_b)

    # -- rollout ------------------------------------------------------------------

    def _env_step(self, env_states, env_actions, eps):
        # replicas step in lockstep: pass t as an unbatched scalar so ring
        # writes stay dynamic-update-slices (engine.step_fn t_shared)
        t0 = env_states.t[0]
        if self.randomize:
            return jax.vmap(
                lambda s, a, e: self.core._step_impl(s, a, e, t_shared=t0)
            )(env_states, env_actions, eps)
        return jax.vmap(
            lambda s, a: self.core._step_impl(s, a, t_shared=t0)
        )(env_states, env_actions)

    def _rollout(self, ts: TrainerState, key):
        def step(carry, k):
            env_states, obs, acar, ccar, eps = carry
            acts, logps, deltas, values, obs_shaped = {}, {}, {}, {}, {}
            new_acar, new_ccar = {}, {}
            for ai, aid in enumerate(self.agents):
                o = self._shape_obs(aid, self._agent_obs(obs, aid))
                obs_shaped[aid] = o
                mu, log_std, ac2 = self._apply_policy(aid, ts.params[aid], o, acar[aid])
                v, cc2 = self._apply_value(aid, ts.value_params[aid], o, ccar[aid])
                new_acar[aid] = ac2
                new_ccar[aid] = cc2
                values[aid] = v
                # stable per-agent stream: fold in the agent index, not
                # hash(aid) (process-salted, irreproducible)
                k_a = jax.random.fold_in(k, ai)
                delta = mu + jnp.exp(log_std) * jax.random.normal(k_a, mu.shape)
                delta = jnp.clip(delta, -self.max_delta, self.max_delta)
                deltas[aid] = delta
                logps[aid] = _gaussian_logprob(mu, log_std, delta)
                acts[aid] = self._absolute(
                    aid, self._agent_obs(obs, aid), delta
                )
            env_actions = dict(acts)
            new_states, new_obs, rewards, done, _ = self._env_step(
                env_states, env_actions, eps
            )
            # auto-reset finished replicas: fresh engine state, fresh
            # hidden carries, and (randomize mode) a fresh world draw
            reset_keys = jax.vmap(lambda s: jax.random.fold_in(s, 7))(new_states.key)
            fresh = jax.vmap(self.core.scn.init_state)(reset_keys)
            new_states = _where_done(done, fresh, new_states)
            for aid in self.agents:
                fresh_c = self._batched_carry(aid)
                new_acar[aid] = _where_done(done, fresh_c, new_acar[aid])
                new_ccar[aid] = _where_done(done, fresh_c, new_ccar[aid])
            if self.randomize:
                # episodes are fixed-horizon and reset in lockstep, so
                # done is all-or-none; gate the (expensive) per-replica
                # world redraw behind a real branch instead of drawing
                # and discarding on every non-boundary step
                def _redraw(eps_in):
                    redraw = jax.vmap(
                        lambda kk: randomize_engine_params(self.scn, kk)
                    )(jax.vmap(lambda s: jax.random.fold_in(s, 13))(new_states.key))
                    return _where_done(done, self._mix_nominal(redraw), eps_in)

                eps = jax.lax.cond(done[0], _redraw, lambda e: e, eps)
            new_obs = jax.vmap(self.core._observations)(new_states)
            rew = {aid: rewards.get(aid if aid != "sep" else
                                    (self.spec.sep_ids[0] if self.spec.sep_ids else aid),
                                    jnp.zeros(self.B)) for aid in self.agents}
            out = {"obs": obs_shaped, "delta": deltas, "logp": logps,
                   "value": values, "reward": rew,
                   "done": done.astype(jnp.float32)}
            return (new_states, new_obs, new_acar, new_ccar, eps), out

        keys = jax.random.split(key, self.T)
        carry0 = (ts.env_states, ts.obs, ts.actor_carry, ts.critic_carry,
                  ts.engine_params)
        (env_states, obs, acar, ccar, eps), traj = jax.lax.scan(step, carry0, keys)
        return env_states, obs, acar, ccar, eps, traj

    # -- GAE ------------------------------------------------------------------

    def _gae(self, rewards, values, dones, last_value):
        def back(gae, x):
            r, v, v_next, d = x
            delta = r + self.gamma * v_next * (1 - d) - v
            gae = delta + self.gamma * self.lmbda * (1 - d) * gae
            return gae, gae

        v_next = jnp.concatenate([values[1:], last_value[None]], axis=0)
        _, adv = jax.lax.scan(
            back, jnp.zeros_like(last_value),
            (rewards, values, v_next, dones), reverse=True,
        )
        return adv, adv + values

    # -- update ------------------------------------------------------------------

    def _sequence_forward(self, aid, pv, obs_seq, dones, carry0):
        """Re-forward [T, mb, ...] sequences through the recurrent torso,
        resetting hidden state at episode boundaries exactly as the
        rollout did."""
        fresh = self._batched_carry(aid, obs_seq.shape[1])

        def body(carries, xs):
            o_t, d_t = xs
            ac, cc = carries
            mu, log_std, ac2 = self._apply_policy(aid, pv["p"], o_t, ac)
            v, cc2 = self._apply_value(aid, pv["v"], o_t, cc)
            ac2 = _where_done(d_t, fresh, ac2)
            cc2 = _where_done(d_t, fresh, cc2)
            return (ac2, cc2), (mu, log_std, v)

        _, (mu, log_std, v) = jax.lax.scan(body, carry0, (obs_seq, dones))
        return mu, log_std, v

    def _agent_update(self, aid, pv0, opt0, obs_seq, dones, carry0,
                      act_seq, old_logp, adv, ret, k_perm):
        """PPO epochs minibatched over the REPLICA axis (sequences stay
        whole for the recurrent torsos), with approximate-KL early stop:
        once |KL| exceeds kl_target, later minibatch updates are no-ops
        (PPO_backup.py:1345-1350, expressed as masked updates under jit)."""

        def loss_fn(pv, idx):
            o = obs_seq[:, idx]
            d = dones[:, idx]
            c0 = jax.tree_util.tree_map(lambda x: x[idx], carry0)
            mu, log_std, v = self._sequence_forward(aid, pv, o, d, c0)
            logp = _gaussian_logprob(mu, log_std, act_seq[:, idx])
            ratio = jnp.exp(logp - old_logp[:, idx])
            a = adv[:, idx]
            s1 = ratio * a
            s2 = jnp.clip(ratio, 1 - self.eps_clip, 1 + self.eps_clip) * a
            entropy = (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum(-1).mean()
            v_loss = ((v - ret[:, idx]) ** 2).mean()
            kl = jnp.mean(old_logp[:, idx] - logp)
            loss = (-jnp.minimum(s1, s2).mean() - self.entropy_coef * entropy
                    + self.value_coef * v_loss)
            return loss, kl

        mb = self.B // self.minibatches
        # all epochs*minibatches index sets up front (distinct permutation
        # per epoch; stable keys so fixed seeds reproduce across runs),
        # then ONE lax.scan over them: the previous unrolled Python loop
        # compiled epochs*minibatches copies of the loss+grad graph, which
        # dominated trainer compile time
        idx_sets = jnp.stack([
            jax.lax.dynamic_slice_in_dim(
                jax.random.permutation(jax.random.fold_in(k_perm, epoch), self.B),
                m * mb, mb)
            for epoch in range(self.epochs)
            for m in range(self.minibatches)
        ])

        def upd(carry, idx):
            pv, opt, stopped, total_loss, n_applied, last_kl = carry
            (loss, kl), grads = jax.value_and_grad(loss_fn, has_aux=True)(pv, idx)
            updates, opt_new = self.tx.update(grads, opt)
            pv_new = optax.apply_updates(pv, updates)
            keep = stopped  # no further updates once KL tripped
            pv = jax.tree_util.tree_map(
                lambda a, b: jnp.where(keep, a, b), pv, pv_new)
            opt = jax.tree_util.tree_map(
                lambda a, b: jnp.where(keep, a, b), opt, opt_new)
            total_loss = total_loss + jnp.where(keep, 0.0, loss)
            n_applied = n_applied + jnp.where(keep, 0.0, 1.0)
            last_kl = jnp.where(keep, last_kl, kl)
            stopped = stopped | (jnp.abs(kl) > self.kl_target)
            return (pv, opt, stopped, total_loss, n_applied, last_kl), None

        carry0_u = (pv0, opt0, jnp.asarray(False), jnp.asarray(0.0),
                    jnp.asarray(0.0), jnp.asarray(0.0))
        (pv, opt, _, total_loss, n_applied, last_kl), _ = jax.lax.scan(
            upd, carry0_u, idx_sets)
        # mean over the updates actually APPLIED: dividing by the full
        # epochs*minibatches count would understate the loss whenever the
        # KL early-stop masked later updates
        return pv, opt, total_loss / jnp.maximum(n_applied, 1.0), last_kl

    def _train_iteration_impl(self, ts: TrainerState):
        if self.mesh is not None:
            # re-assert the layout inside jit so callers that pass
            # unsharded state (e.g. a restored checkpoint) still train
            # sharded — the trainer, not the caller, owns the shardings
            ts = ts.replace(
                env_states=self._constrain(ts.env_states),
                obs=self._constrain(ts.obs),
                actor_carry=self._constrain(ts.actor_carry),
                critic_carry=self._constrain(ts.critic_carry),
                engine_params=self._constrain(ts.engine_params),
                params=self._constrain(ts.params, batched=False),
                value_params=self._constrain(ts.value_params, batched=False),
                opt_states=self._constrain(ts.opt_states, batched=False),
            )
        key, k_roll, k_perm = jax.random.split(ts.key, 3)
        carry0_a = ts.actor_carry  # rollout-start carries for re-forward
        env_states, obs, acar, ccar, eps, traj = self._rollout(ts, k_roll)

        metrics = {}
        params, vparams, opts = dict(ts.params), dict(ts.value_params), dict(ts.opt_states)
        for ai, aid in enumerate(self.agents):
            # bootstrap value of the post-rollout observation
            o_last = self._shape_obs(aid, self._agent_obs(obs, aid))
            last_v, _ = self._apply_value(aid, vparams[aid], o_last, ccar[aid])

            adv, ret = self._gae(self.reward_scale * traj["reward"][aid],
                                 traj["value"][aid], traj["done"], last_v)
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)

            pv = {"p": params[aid], "v": vparams[aid]}
            carry0 = (carry0_a[aid], ts.critic_carry[aid])
            pv, opt, loss, kl = self._agent_update(
                aid, pv, opts[aid], traj["obs"][aid], traj["done"],
                carry0, traj["delta"][aid], traj["logp"][aid],
                adv, ret, jax.random.fold_in(k_perm, ai),
            )
            params[aid], vparams[aid], opts[aid] = pv["p"], pv["v"], opt
            metrics[f"{aid}/loss"] = loss
            metrics[f"{aid}/kl"] = kl
            metrics[f"{aid}/reward"] = traj["reward"][aid].sum(0).mean()

        new_ts = TrainerState(env_states=env_states, obs=obs, params=params,
                              value_params=vparams, opt_states=opts,
                              actor_carry=acar, critic_carry=ccar,
                              engine_params=eps, key=key,
                              iteration=ts.iteration + 1)
        return new_ts, metrics

    def train_iteration(self, ts: TrainerState):
        ts, metrics = self._train_iter(ts)
        return ts, {k: float(v) for k, v in metrics.items()}

    # -- persistence ---------------------------------------------------------------

    def save(self, ts: TrainerState, path: str, extra: Optional[dict] = None):
        import pickle

        with open(path, "wb") as f:
            pickle.dump({
                "params": jax.device_get(ts.params),
                "value_params": jax.device_get(ts.value_params),
                "config": {
                    "net_type": self.net_type, "hidden_dim": self.hidden_dim,
                    "num_envs": self.B, "rollout_len": self.T,
                    "obs_mode": self.core.obs_mode,
                    "randomize": self.randomize,
                    **(extra or {}),
                },
            }, f)
