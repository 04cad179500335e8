"""NetworkState: the struct-of-arrays simulation state pytree.

Replaces the per-object arrays of the reference BaseLink/Link
(src/LTM/link.py:4-99) with fixed-shape ring buffers sized to the maximum
lookback horizon H instead of the full horizon T+1, so device memory is
O(E*H) regardless of simulation length.  Full trajectories are streamed
out as ``lax.scan`` outputs when recording is requested.

All flow quantities use the scenario's flow dtype (float32 by default,
float64 in CPU parity-test mode); kinematic quantities (travel time,
density, speed, pedestrian counts) are float32 to mirror the reference's
array dtypes (link.py:82-97), which matters for bit-level parity of
``round(avg_travel_time / unit_time)`` lookback indices.
"""

from typing import Any

import jax
import jax.numpy as jnp

from .pytree import pytree_dataclass


@pytree_dataclass
class EngineParams:
    """Per-link / per-node parameters that may vary across vmapped env
    replicas (domain randomization perturbs k_critical/k_jam/
    free_flow_speed and demand/OD tables; see reference
    src/utils/env_loader.py:363-424)."""

    length: jnp.ndarray  # [E]
    width: jnp.ndarray  # [E]
    free_flow_speed: jnp.ndarray  # [E]
    k_critical: jnp.ndarray  # [E]
    k_jam: jnp.ndarray  # [E]
    gamma: jnp.ndarray  # [E]
    bi_factor: jnp.ndarray  # [E]
    activity_probability: jnp.ndarray  # [E]
    speed_noise_std: jnp.ndarray  # [E]
    demand: jnp.ndarray  # [N, T+1]
    od_table: jnp.ndarray  # [P, T+1]
    phi_base: jnp.ndarray  # [N, M, M] static equal turning fractions
    # Per-node virtual-slot receiving capacity: big-M (1e6, node.py:22)
    # where the node's virtual link is ACTIVE, 0 elsewhere.  Per-replica
    # so in-vmap OD-node randomization can open/close origin/destination
    # nodes (reference env_loader.py:261-359 rebuilds the network
    # host-side instead).
    virt_recv: jnp.ndarray  # [N]

    # Derived per-link constants (link.py:61-91).  These follow the
    # *current* physical parameters above, so a replica whose speed or
    # capacity was randomized sees consistent free-flow travel times and
    # N-curve lookbacks (not the nominal build-time values).  Recomputed
    # by pednstream_tpu.randomize whenever the base parameters change.
    max_travel_time: jnp.ndarray  # [E] f32, jam clamp length/0.05 (link.py:63)
    travel_time0: jnp.ndarray  # [E] f32, initial travel time (link.py:83)
    tt_freeflow32: jnp.ndarray  # [E] f32, length/v_f in f64 then cast (functions.py:120-121)
    free_flow_tau: jnp.ndarray  # [E] i32, round(tt0/dt) (link.py:86)
    tau_shockwave: jnp.ndarray  # [E] i32, round(L/(w*dt)) (link.py:380)


@pytree_dataclass
class NetworkState:
    """Carry of the per-step scan."""

    t: jnp.ndarray  # scalar int32, next time step to execute (starts at 1)
    key: jax.Array  # PRNG key (stochastic mode)

    # ring buffers, time-major [H, E] (time index i lives at row i % H):
    # the per-step row write touches one contiguous row (ops/ncurve.py).
    cum_in_ring: jnp.ndarray
    cum_out_ring: jnp.ndarray
    inflow_ring: jnp.ndarray
    tt_ring: jnp.ndarray  # [W, E] float32

    # current scalars [E]
    cum_in: jnp.ndarray
    cum_out: jnp.ndarray
    inflow: jnp.ndarray
    outflow: jnp.ndarray
    num_peds: jnp.ndarray  # float32
    density: jnp.ndarray  # float32
    speed: jnp.ndarray  # float32
    travel_time: jnp.ndarray  # float32
    link_flow: jnp.ndarray  # float32
    avg_tt: jnp.ndarray  # float32
    tt_run_sum: jnp.ndarray  # float32
    sending_prev: jnp.ndarray  # sending_flow[t-1] after step t (init -1 sentinel, link.py:16)
    recv_prev: jnp.ndarray  # receiving_flow[t-1] after step t (init -1 sentinel, link.py:17)

    # control surface
    back_gate: jnp.ndarray  # [E]; front gate of e == back_gate[reverse_idx[e]] (link.py:110-126)
    sep_width: jnp.ndarray  # [E]; separators only (link.py:462-478)

    # virtual link flows per node (origin departures / destination arrivals)
    virt_dep: jnp.ndarray  # [N]
    virt_arr: jnp.ndarray  # [N]
    virt_dep_cum: jnp.ndarray  # [N]
    virt_arr_cum: jnp.ndarray  # [N]


@pytree_dataclass
class StepOutputs:
    """Per-step recorded trajectory slice (scan ys)."""

    inflow: jnp.ndarray
    outflow: jnp.ndarray
    cum_in: jnp.ndarray
    cum_out: jnp.ndarray
    num_peds: jnp.ndarray
    density: jnp.ndarray
    speed: jnp.ndarray
    travel_time: jnp.ndarray
    link_flow: jnp.ndarray
    sending: jnp.ndarray
    receiving: jnp.ndarray
    back_gate: jnp.ndarray
    sep_width: jnp.ndarray
    virt_dep: jnp.ndarray
    virt_arr: jnp.ndarray
