"""Link-axis (simulation-state) sharding — SURVEY §2.6's "TP" analog.

The DP path (parallel/mesh.py) shards the REPLICA axis: every device
holds whole networks.  A network whose state exceeds one device's
memory — the blueprint's stated 10k+-link motivation; state is O(E*H)
ring buffers — needs the other decomposition: shard the LINK axis of a
single replica across the mesh, so each device holds a block of directed
links (N-curve rings, FD state, control surface) and only the small
per-step exchange vectors cross devices.

There is no reference analog to cite: the reference is a single-process
object graph (SURVEY §2.6 maps its absence of TP).  This module is the
planned equivalent from the blueprint's own checklist.

Design — the scaling-book recipe (pick a mesh, annotate shardings, let
XLA's SPMD partitioner insert collectives):

  * ``NetworkState`` link-axis leaves get ``NamedSharding P('link')``;
    ring buffers ``[H, E]`` get ``P(None, 'link')`` — the window axis
    stays device-local, so the one-hot ring reductions
    (engine._ring_read) remain shard-local;
  * node-axis leaves (``[N]`` virtual flows, ``[N, T+1]`` demand,
    ``[N, M, M]`` phi) are REPLICATED: they are O(N) / O(N*M^2) — a
    rounding error next to the O(E*H) rings — and N is rarely divisible
    by the mesh, so sharding them buys nothing and costs generality;
  * the per-step cross-shard traffic GSPMD inserts is O(E + N*M) floats
    — the sending/receiving vectors feeding the (replicated) node solve
    and the node flow matrices feeding the link write-back — a rounding
    error next to the O(E*H) ring state that stays resident;
  * the reverse-link lane swap (engine._make_rev) rides the same O(E)
    exchange: corridor pairs are adjacent by construction (topology.py:
    reverse_idx == e ^ 1), so only pairs straddling a shard edge
    communicate at all.

The directed-link count E must be divisible by the link axis size; the
sharding helpers raise otherwise.  E is always even (links come in
corridor pairs), but e.g. melbourne's E = 938 does not divide by 4, and
grid_50x50's E = 9,800 does.

Bit-exactness: partitioning changes no floating-point reduction order —
every in-step reduction runs over unsharded axes (the ring window H, the
node slot axis M) — so the sharded program is BITWISE equal to the
single-device one *with params passed as arguments on both sides*.
(Closing over EngineParams instead embeds them as constants, and XLA
rewrites divide-by-constant into multiply-by-reciprocal — a 1-ulp
difference in density that is a constant-folding artifact, not a
sharding one.)  tests/test_link_shard.py pins bitwise equality on the
8-device virtual CPU mesh, plus an HLO check that no collective
materializes a full ring (the memory claim, not just the numerics).
"""

from functools import partial
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import EngineParams, NetworkState


def link_state_shardings(mesh: Mesh, axis: str = "link") -> NetworkState:
    """A NetworkState pytree of NamedShardings: [E]/[H,E] leaves sharded
    on the link axis, node-axis [N] leaves and scalars replicated."""
    ring = NamedSharding(mesh, P(None, axis))  # [H, E]: window local
    vec = NamedSharding(mesh, P(axis))  # [E]
    rep = NamedSharding(mesh, P())  # scalars and [N] node leaves
    return NetworkState(
        t=rep, key=rep,
        cum_in_ring=ring, cum_out_ring=ring, inflow_ring=ring, tt_ring=ring,
        cum_in=vec, cum_out=vec, inflow=vec, outflow=vec,
        num_peds=vec, density=vec, speed=vec, travel_time=vec,
        link_flow=vec, avg_tt=vec, tt_run_sum=vec,
        sending_prev=vec, recv_prev=vec,
        back_gate=vec, sep_width=vec,
        virt_dep=rep, virt_arr=rep, virt_dep_cum=rep, virt_arr_cum=rep,
    )


def link_params_shardings(mesh: Mesh, axis: str = "link") -> EngineParams:
    """EngineParams shardings: per-link [E] leaves sharded; node-axis
    leaves (demand [N,T+1], phi [N,M,M], virt_recv [N]) and the OD table
    replicated — O(N*T + N*M^2) bytes vs the O(E*H) rings they unblock."""
    vec = NamedSharding(mesh, P(axis))  # [E]
    rep = NamedSharding(mesh, P())
    return EngineParams(
        length=vec, width=vec, free_flow_speed=vec, k_critical=vec,
        k_jam=vec, gamma=vec, bi_factor=vec, activity_probability=vec,
        speed_noise_std=vec,
        demand=rep, od_table=rep, phi_base=rep, virt_recv=rep,
        max_travel_time=vec, travel_time0=vec, tt_freeflow32=vec,
        free_flow_tau=vec, tau_shockwave=vec,
    )


def check_link_divisible(n_links: int, mesh: Mesh, axis: str = "link") -> None:
    """Raise unless the link axis of size ``n_links`` splits evenly over
    the mesh axis ``axis``."""
    n = mesh.shape[axis]
    if n_links % n:
        raise ValueError(
            f"{n_links} directed links do not divide over the {n}-device "
            f"'{axis}' mesh axis; use a mesh size that divides {n_links}")


def shard_link_state(state: NetworkState, mesh: Mesh,
                     axis: str = "link") -> NetworkState:
    """Physically place a state with its link axis sharded over ``mesh``."""
    check_link_divisible(state.cum_in.shape[-1], mesh, axis)
    return jax.device_put(state, link_state_shardings(mesh, axis))


def shard_link_params(ep: EngineParams, mesh: Mesh,
                      axis: str = "link") -> EngineParams:
    check_link_divisible(ep.length.shape[-1], mesh, axis)
    return jax.device_put(ep, link_params_shardings(mesh, axis))


def make_link_sharded_simulate(scn, mesh: Mesh, num_steps: int,
                               stochastic: bool = False,
                               axis: str = "link"):
    """Jitted ``(ep, state) -> final_state`` over ``num_steps`` engine
    steps with the simulation state sharded on the link axis.

    Semantics are those of ``engine.simulate(..., record=False)`` — same
    pure step function, different physical layout; GSPMD inserts the
    node-exchange collectives.
    """
    from ..engine import step_fn

    check_link_divisible(scn.n_links, mesh, axis)
    st_sh = link_state_shardings(mesh, axis)
    ep_sh = link_params_shardings(mesh, axis)

    @partial(jax.jit, in_shardings=(ep_sh, st_sh), out_shardings=st_sh)
    def run(ep: EngineParams, state: NetworkState) -> NetworkState:
        def body(st, _):
            return step_fn(scn, ep, st, stochastic=stochastic,
                           record=False)[0], None

        return jax.lax.scan(body, state, None, length=num_steps)[0]

    return run


def make_link_sharded_step(scn, mesh: Mesh, stochastic: bool = False,
                           axis: str = "link"):
    """Jitted single sharded step ``(ep, state) -> state`` (interactive /
    RL-control stepping on a link-sharded network)."""
    from ..engine import step_fn

    check_link_divisible(scn.n_links, mesh, axis)
    st_sh = link_state_shardings(mesh, axis)
    ep_sh = link_params_shardings(mesh, axis)

    @partial(jax.jit, in_shardings=(ep_sh, st_sh), out_shardings=st_sh)
    def step(ep: EngineParams, state: NetworkState) -> NetworkState:
        return step_fn(scn, ep, state, stochastic=stochastic,
                       record=False)[0]

    return step


def hybrid_state_shardings(mesh: Mesh, env_axis: str = "env",
                           link_axis: str = "link") -> NetworkState:
    """Shardings for a BATCHED NetworkState (leading replica axis) on a
    2-D mesh (parallel/mesh.py make_mesh_2d): replicas block over
    ``env`` (pure DP — rollouts never communicate across it), each
    replica's link axis blocks over ``link`` (it carries the per-step
    node exchange).  SURVEY §2.6's layout, DP x state-sharding in one
    SPMD program; on NVLink-connected cards every pair of devices is
    equally close, so which cards form a link group does not matter."""
    ring = NamedSharding(mesh, P(env_axis, None, link_axis))  # [B, H, E]
    vec = NamedSharding(mesh, P(env_axis, link_axis))  # [B, E]
    b = NamedSharding(mesh, P(env_axis))  # [B] and [B, N]
    return NetworkState(
        t=b, key=b,
        cum_in_ring=ring, cum_out_ring=ring, inflow_ring=ring, tt_ring=ring,
        cum_in=vec, cum_out=vec, inflow=vec, outflow=vec,
        num_peds=vec, density=vec, speed=vec, travel_time=vec,
        link_flow=vec, avg_tt=vec, tt_run_sum=vec,
        sending_prev=vec, recv_prev=vec,
        back_gate=vec, sep_width=vec,
        virt_dep=b, virt_arr=b, virt_dep_cum=b, virt_arr_cum=b,
    )


def shard_hybrid_state(states: NetworkState, mesh: Mesh,
                       env_axis: str = "env",
                       link_axis: str = "link") -> NetworkState:
    check_link_divisible(states.cum_in.shape[-1], mesh, link_axis)
    return jax.device_put(states,
                          hybrid_state_shardings(mesh, env_axis, link_axis))


def make_hybrid_sharded_simulate(scn, mesh: Mesh, num_steps: int,
                                 stochastic: bool = False,
                                 env_axis: str = "env",
                                 link_axis: str = "link"):
    """Jitted ``(ep, batched_states) -> final_batched_states`` with the
    replica axis sharded over ``env`` and the link axis over ``link``
    (semantics of ``engine.simulate_batched``; shared unbatched
    EngineParams, link-sharded as in the 1-D path)."""
    from ..engine import simulate_batched

    check_link_divisible(scn.n_links, mesh, link_axis)
    st_sh = hybrid_state_shardings(mesh, env_axis, link_axis)
    ep_sh = link_params_shardings(mesh, link_axis)

    @partial(jax.jit, in_shardings=(ep_sh, st_sh), out_shardings=st_sh)
    def run(ep: EngineParams, states: NetworkState) -> NetworkState:
        return simulate_batched(scn, ep, states, num_steps,
                                stochastic=stochastic)

    return run


def assert_no_full_ring_collectives(compiled, ring_bytes: int) -> Tuple[int, int]:
    """Scan optimized HLO for collectives materializing a full-size ring.

    The whole point of link-axis sharding is that the O(E*H) rings never
    leave their shards; GSPMD silently falling back to an all-gather of a
    ring would still be numerically correct but would void the memory
    claim.  Returns (n_collectives, n_violations) and raises AssertionError
    on violation.  ``ring_bytes`` = H * E * itemsize of one full ring.
    """
    import re

    hlo = compiled.as_text()
    n_coll = 0
    bad = []
    itemsizes = {"f32": 4, "f64": 8, "s32": 4, "u32": 4, "pred": 1,
                 "bf16": 2, "f16": 2, "s64": 8, "u64": 8}
    coll_re = re.compile(r"\b(?:all-gather|all-reduce|reduce-scatter"
                         r"|collective-permute|all-to-all)"
                         r"(?:-start|-done)?\(")
    shape_re = re.compile(r"(\w+)\[([\d,]*)\]")
    for line in hlo.splitlines():
        line_s = line.strip()
        if "=" not in line_s:
            continue
        lhs, rhs = line_s.split("=", 1)
        m = coll_re.search(rhs)
        if not m:
            continue
        n_coll += 1
        # the result shape sits between '=' and the op name: a single
        # array 'f32[16,8]{1,0}' or — for the combiner passes' variadic
        # collectives — a TUPLE '(f32[16,8], f32[8])'; check every
        # member shape, since a full ring hidden inside a combined
        # all-reduce still voids the claim
        for dt, dims_s in shape_re.findall(rhs[:m.start()]):
            dims = [int(d) for d in dims_s.split(",") if d]
            itemsize = itemsizes.get(dt, 4)
            nbytes = itemsize * int(np.prod(dims)) if dims else 0
            if nbytes >= ring_bytes:
                bad.append(line_s[:200])
                break
    if bad:
        raise AssertionError(
            "collective(s) materialize a full ring — link sharding "
            "degenerated to replication:\n" + "\n".join(bad)
        )
    return n_coll, len(bad)
