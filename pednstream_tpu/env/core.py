"""Pure functional multi-agent environment core.

The reference's PettingZoo env mutates a live object graph
(rl/pz_pednet_env.py, rl/builders.py).  Here the whole RL step —
action clipping + application, ``action_gap`` engine steps, observation
building, reward computation, termination — is ONE pure jitted function
``(state, actions, key) -> (state, obs, rewards, done)``, so thousands of
env replicas vmap into a single XLA program and shard across a device mesh.

Action semantics (rl/builders.py:241-353):
  separators: target width for the forward direction, rate-clipped to
  0.25*unit_time m/step and bounded to [min_sep, total-min_sep]; writing
  also reallocates the reverse direction (link.py:462-478).
  gaters: per-out-link back-gate width, rate-clipped and bounded [0, width].

Observation modes option1..option5 (rl/builders.py:119-177) and the gate
reward (travel-time + density penalty + variance penalty,
pz_pednet_env.py:548-581) are reproduced feature-for-feature.  The
reference's reward quirk (``return`` inside the agent loop so only the
first agent is rewarded, pz_pednet_env.py:581) is available as
``reward_mode='reference_quirk'``; the default 'all' rewards every agent
(separators get the same travel-time shaped reward over their pair).
"""

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import step_fn
from ..scenario import Scenario
from ..state import NetworkState
from .agents import FEATURES_PER_LINK, AgentSpec


def _poison_if_not_lockstep(states_in, st, obs, rewards, done, info):
    """Runtime guard for the lockstep-batch contract (batch_step).

    The lockstep fast path closes ``t = states.t[0]`` over the vmap; if a
    caller stepped replicas to heterogeneous ``t`` (e.g. reset a subset
    manually) the ring reads/writes would be silently wrong.  A host-side
    assert would force a device round-trip per eager step (the eager path
    is dispatch-latency-bound), so instead the violation is made LOUD on
    device: obs/reward leaves become NaN and the new state's clock a
    negative sentinel.  Cost is a [B] reduce + scalar selects.
    """
    ok = jnp.all(states_in.t == states_in.t[0])

    def _poison(x):
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating):
            return jnp.where(ok, x, jnp.nan)
        return x

    obs = jax.tree_util.tree_map(_poison, obs)
    rewards = jax.tree_util.tree_map(_poison, rewards)
    st = st.replace(t=jnp.where(ok, st.t, -(2**30)))
    return st, obs, rewards, done, info


class PedNetEnvCore:
    def __init__(
        self,
        scn: Scenario,
        spec: AgentSpec,
        obs_mode: str = "option1",
        normalize_obs: bool = False,
        action_gap: int = 1,
        reward_mode: str = "all",
        stochastic: bool = True,
        record: bool = False,
        global_reward_coef: float = 0.0,
    ):
        if obs_mode not in FEATURES_PER_LINK:
            raise ValueError(
                f"obs_mode must be one of {list(FEATURES_PER_LINK)}, got: {obs_mode}"
            )
        self.scn = scn
        self.spec = spec
        self.obs_mode = obs_mode
        self.normalize_obs = normalize_obs
        self.action_gap = action_gap
        self.reward_mode = reward_mode
        self.stochastic = stochastic
        self.record = record
        if global_reward_coef < 0.0:
            # the shaping term is SUBTRACTED (-coef * total in-network
            # count); a mis-signed coef would silently train unshaped
            raise ValueError(
                f"global_reward_coef must be >= 0, got {global_reward_coef}")
        self.global_reward_coef = float(global_reward_coef)
        # static normalization constants (rl/builders.py:63-66)
        self.density_norm = 6.0
        self.speed_norm = 1.5
        self.flow_norm = 20.0

        # static agent index arrays (NumPy: embedded as backend-independent
        # constants in jitted closures)
        self._sep_fwd = np.asarray(spec.sep_fwd_link)
        self._sep_total = np.asarray(spec.sep_total_width)
        self._gate_links = [np.asarray(g) for g in spec.gate_links]
        self._gate_widths = [np.asarray(w) for w in spec.gate_link_widths]

        self._step = jax.jit(self._step_impl)

    # -- actions -------------------------------------------------------------

    def _apply_actions(self, st: NetworkState, actions: Dict[str, jnp.ndarray]) -> NetworkState:
        f = self.scn.ftype
        back_gate = st.back_gate
        sep_width = st.sep_width
        rev = self.scn.reverse_idx

        if len(self.spec.sep_ids):
            fwd = self._sep_fwd
            target = jnp.asarray(actions["sep"], dtype=f).reshape(-1)
            cur = sep_width[fwd]
            delta = jnp.clip(target - cur, -self.spec.max_delta_sep, self.spec.max_delta_sep)
            val = jnp.where(
                jnp.abs(target - cur) > self.spec.max_delta_sep, cur + delta, target
            )
            val = jnp.clip(val, self.spec.min_sep_width, self._sep_total - self.spec.min_sep_width)
            rv = self._sep_total - val
            sep_width = sep_width.at[fwd].set(val).at[rev[fwd]].set(rv)
            back_gate = back_gate.at[fwd].set(val).at[rev[fwd]].set(rv)

        if len(self.spec.gate_ids):
            for i, agent_id in enumerate(self.spec.gate_ids):
                links = self._gate_links[i]
                widths = self._gate_widths[i].astype(f)
                target = jnp.asarray(actions[agent_id], dtype=f).reshape(-1)
                cur = back_gate[links]
                delta = jnp.clip(target - cur, -self.spec.max_delta_gate, self.spec.max_delta_gate)
                val = jnp.where(
                    jnp.abs(target - cur) > self.spec.max_delta_gate, cur + delta, target
                )
                val = jnp.clip(val, 0.0, widths)
                back_gate = back_gate.at[links].set(val)

        return st.replace(back_gate=back_gate, sep_width=sep_width)

    # -- observations ----------------------------------------------------------

    def _shared_density(self, st: NetworkState) -> jnp.ndarray:
        scn, ep = self.scn, self.scn.engine_params
        rev = scn.reverse_idx
        area = jnp.where(scn.is_separator, ep.length * st.sep_width, ep.length * ep.width)
        return jnp.where(
            scn.is_separator,
            st.num_peds / area.astype(jnp.float32),
            (st.num_peds + st.num_peds[rev]) / area.astype(jnp.float32),
        )

    def _observations(self, st: NetworkState) -> Dict[str, jnp.ndarray]:
        scn = self.scn
        rev = scn.reverse_idx
        inflow, outflow = st.inflow, st.outflow
        obs: Dict[str, jnp.ndarray] = {}

        if len(self.spec.sep_ids):
            fwd = self._sep_fwd
            o = jnp.stack(
                [inflow[fwd], outflow[fwd], inflow[rev[fwd]], outflow[rev[fwd]]], axis=-1
            ).astype(jnp.float32)
            if self.normalize_obs:
                o = o / self.flow_norm  # option1 separator normalization
            obs["sep"] = o

        dens = self._shared_density(st)
        kj = scn.engine_params.k_jam
        for i, agent_id in enumerate(self.spec.gate_ids):
            links = self._gate_links[i]
            rl = rev[links]
            bg = st.back_gate[links].astype(jnp.float32)
            mode = self.obs_mode
            if mode == "option1":
                feats = [inflow[links], outflow[rl], bg]
            elif mode == "option2":
                feats = [inflow[links], outflow[rl], dens[links], bg]
            elif mode == "option3":
                feats = [inflow[links], outflow[links], inflow[rl], outflow[rl], bg]
            elif mode == "option4":
                feats = [dens[links] / kj[links].astype(jnp.float32), bg]
            else:  # option5
                feats = [inflow[links], outflow[links], inflow[rl], outflow[rl],
                         st.speed[links], dens[links], bg]
            o = jnp.stack([f.astype(jnp.float32) for f in feats], axis=-1).reshape(-1)
            if self.normalize_obs:
                o = self._normalize_gater(o)
            obs[agent_id] = o
        return obs

    def _normalize_gater(self, o: jnp.ndarray) -> jnp.ndarray:
        """Static per-mode normalization (rl/builders.py:203-238)."""
        fpl = FEATURES_PER_LINK[self.obs_mode]
        o = o.reshape(-1, fpl)
        if self.obs_mode in ("option1", "option2"):
            o = o.at[:, 0].divide(self.flow_norm).at[:, 1].divide(self.flow_norm)
        elif self.obs_mode in ("option3", "option4"):
            o = o.at[:, 0].divide(self.density_norm)
            if fpl > 2:
                o = o.at[:, 1].divide(self.flow_norm).at[:, 2].divide(self.flow_norm)
        return o.reshape(-1)

    # -- rewards ---------------------------------------------------------------

    def _rewards(self, st: NetworkState, ep=None) -> Dict[str, jnp.ndarray]:
        """Gate reward (pz_pednet_env.py:548-581): -(T_fwd + T_rev) per out
        link, -10*(k - k_critical) when shared density > 4, minus
        10 * mean|k - mean k| variance penalty.

        Deliberate divergence from the reference: travel time is clamped
        to the engine's jam clamp ``max_travel_time`` (= length/0.05,
        link.py:63) before entering the reward.  Near full jam the FD
        speed underflows to a tiny positive value instead of 0, so raw
        length/speed can reach ~1e9 (f32; ~1e15 in the reference's f64)
        and a single near-jammed link would dwarf every other reward
        signal.  The clamp bounds the per-link penalty at the same value
        the engine itself uses when speed == 0.
        """
        scn = self.scn
        ep = scn.engine_params if ep is None else ep
        rev = scn.reverse_idx
        dens = self._shared_density(st)
        tt = jnp.minimum(st.travel_time, ep.max_travel_time)
        kc = ep.k_critical
        rewards: Dict[str, jnp.ndarray] = {}

        for i, agent_id in enumerate(self.spec.gate_ids):
            links = self._gate_links[i]
            d = dens[links]
            r = -(tt[links] + tt[rev[links]]).sum()
            r = r - jnp.where(d > 4.0, 10.0 * (d - kc[links].astype(jnp.float32)), 0.0).sum()
            if len(self.spec.gate_links[i]) > 1:
                avg = d.mean()
                r = r - 10.0 * jnp.abs(d - avg).mean()
            rewards[agent_id] = r.astype(jnp.float32)

        for i, agent_id in enumerate(self.spec.sep_ids):
            if self.reward_mode == "reference_quirk":
                continue
            fwd = self._sep_fwd[i]
            rewards[agent_id] = (-(tt[fwd] + tt[rev[fwd]])).astype(jnp.float32)

        if self.reward_mode == "reference_quirk" and self.spec.agent_ids:
            # only the first agent's reward survives (pz_pednet_env.py:581)
            first = self.spec.agent_ids[0]
            rewards = (
                {first: rewards[first]} if first in rewards else {}
            )

        if self.global_reward_coef > 0.0 and rewards:
            # Optional delay-aligned shaping (training-time only; every
            # evaluation env keeps the default 0.0 so eval rewards stay
            # the reference signal): subtract a small shared multiple of
            # the TOTAL in-network count.  Summed over engine steps,
            # in-network count IS total network time (total delay plus
            # the free-flow constant), so this term lets a local gate
            # reward see a remote gridlock that its own clamped link
            # travel times cannot express (docs/RESULTS.md "why the two
            # axes diverge").
            g = -self.global_reward_coef * st.num_peds.sum().astype(jnp.float32)
            rewards = {k: v + g for k, v in rewards.items()}
        return rewards

    # -- step/reset ------------------------------------------------------------

    def _step_impl(self, st: NetworkState, actions: Dict[str, jnp.ndarray],
                   ep=None, t_shared=None):
        ep = self.scn.engine_params if ep is None else ep
        st = self._apply_actions(st, actions)

        def body(carry, tcur):
            s, acc = carry
            s, o = step_fn(self.scn, ep, s,
                           stochastic=self.stochastic, record=self.record,
                           t_shared=tcur)
            r = self._rewards(s, ep)
            acc = {k: acc[k] + r[k] for k in r}
            return (s, acc), o

        zero_r = {k: jnp.zeros((), jnp.float32) for k in self._rewards(st, ep)}
        # action_gap engine steps per RL step (pz_pednet_env.py:225-247);
        # in lockstep-batched mode the per-substep time rides the scan xs
        # as an unbatched scalar (see engine.step_fn t_shared)
        ts = None if t_shared is None else t_shared + jnp.arange(
            self.action_gap, dtype=jnp.int32)
        (st, rewards_acc), outs = jax.lax.scan(
            body, (st, zero_r), ts, length=self.action_gap
        )
        obs = self._observations(st)
        done = st.t > self.scn.simulation_steps  # sim_step >= simulation_steps
        return st, obs, rewards_acc, done, outs if self.record else ()

    def reset(self, key: Optional[jax.Array] = None) -> Tuple[NetworkState, Dict]:
        st = self.scn.init_state(key)
        return st, self._observations(st)

    def step(self, st: NetworkState, actions: Dict[str, jnp.ndarray]):
        return self._step(st, actions)

    # -- batched API -------------------------------------------------------------

    @property
    def _jit_batch_reset(self):
        if not hasattr(self, "_jit_batch_reset_fn"):
            self._jit_batch_reset_fn = jax.jit(jax.vmap(lambda k: self.reset(k)))
        return self._jit_batch_reset_fn

    @property
    def _jit_batch_step(self):
        if not hasattr(self, "_jit_batch_step_fn"):
            # t is identical across lockstep replicas: close it over the
            # vmap as an unbatched scalar so ring-row writes stay
            # dynamic-update-slices instead of batching into scatters
            def _batched(states, actions):
                t0 = states.t[0]
                st, obs, rewards, done, info = jax.vmap(
                    lambda s, a: self._step_impl(s, a, t_shared=t0)
                )(states, actions)
                return _poison_if_not_lockstep(states, st, obs, rewards,
                                               done, info)

            self._jit_batch_step_fn = jax.jit(_batched)
        return self._jit_batch_step_fn

    @property
    def _jit_batch_step_hetero(self):
        if not hasattr(self, "_jit_batch_step_het_fn"):
            self._jit_batch_step_het_fn = jax.jit(jax.vmap(self._step_impl))
        return self._jit_batch_step_het_fn

    def batch_reset(self, keys: jax.Array):
        """vmapped reset over a batch of PRNG keys -> batched state/obs."""
        return self._jit_batch_reset(keys)

    def batch_step(self, states: NetworkState, actions: Dict[str, jnp.ndarray],
                   lockstep: bool = True):
        """vmapped step: states and every action leaf carry a leading batch
        axis.  One XLA program steps all replicas.

        lockstep=True (default) requires every replica to share the same
        ``states.t`` — the time is closed over the vmap as an unbatched
        scalar, which keeps the engine's ring-row writes
        dynamic-update-slices instead of per-replica scatters (~2x
        faster).  Every batched path in this package (batch_reset +
        fixed-horizon episodes with synchronized resets) satisfies it.
        Pass ``lockstep=False`` if your replicas carry heterogeneous
        ``t`` values (e.g. you reset a subset manually) — correctness
        over speed."""
        fn = self._jit_batch_step if lockstep else self._jit_batch_step_hetero
        st, obs, rewards, done, _ = fn(states, actions)
        return st, obs, rewards, done

    @property
    def _jit_batch_step_randomized(self):
        if not hasattr(self, "_jit_batch_step_rand_fn"):
            def _batched(states, actions, eps):
                t0 = states.t[0]
                st, obs, rewards, done, info = jax.vmap(
                    lambda s, a, e: self._step_impl(s, a, e, t_shared=t0)
                )(states, actions, eps)
                return _poison_if_not_lockstep(states, st, obs, rewards,
                                               done, info)

            self._jit_batch_step_rand_fn = jax.jit(_batched)
        return self._jit_batch_step_rand_fn

    @property
    def _jit_batch_step_randomized_hetero(self):
        if not hasattr(self, "_jit_batch_step_rand_het_fn"):
            self._jit_batch_step_rand_het_fn = jax.jit(
                jax.vmap(self._step_impl, in_axes=(0, 0, 0))
            )
        return self._jit_batch_step_rand_het_fn

    def batch_step_randomized(self, states, actions, engine_params,
                              lockstep: bool = True):
        """Batched step with PER-REPLICA EngineParams (domain
        randomization in-vmap; see pednstream_tpu.randomize).  For the
        ``lockstep`` contract see :meth:`batch_step`."""
        fn = (self._jit_batch_step_randomized if lockstep
              else self._jit_batch_step_randomized_hetero)
        st, obs, rewards, done, _ = fn(states, actions, engine_params)
        return st, obs, rewards, done
