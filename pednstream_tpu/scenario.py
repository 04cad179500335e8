"""Scenario: compiled static topology + device parameters + state factory.

``build_scenario`` is the array-program equivalent of constructing the
reference ``Network`` object (src/LTM/network.py:56-121): it compiles the
adjacency matrix, link parameters, controller configuration, demand
curves, OD tables and routing turn tables into device-ready arrays, and
produces the initial :class:`NetworkState`.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .demand import ODManager, build_demand_table
from .routing import PathSetBuilder, RoutingTables, build_routing_tables
from .state import EngineParams, NetworkState
from .topology import TopologySpec, build_topology, parse_controllers


def derive_link_constants(length, free_flow_speed, k_critical, k_jam,
                          unit_time, xp=np):
    """Per-link constants derived from the physical parameters
    (link.py:61-91).  Used at scenario build time (NumPy, f64 inputs —
    matches the reference's float math for golden parity) and inside
    per-replica domain randomization (jnp, traced f32 inputs) so derived
    quantities track randomized speeds/capacities."""
    max_tt = length / 0.05  # jam travel-time clamp (link.py:63)
    tt0 = xp.minimum(length / free_flow_speed, max_tt)  # link.py:83
    capacity = free_flow_speed * k_critical
    shockwave = capacity / (k_jam - k_critical)  # link.py:61
    fftau = xp.round(tt0.astype(xp.float32) / unit_time).astype(xp.int32)
    tau_shock = xp.round(length / (shockwave * unit_time)).astype(xp.int32)
    return {
        "max_travel_time": max_tt.astype(xp.float32),
        "travel_time0": tt0.astype(xp.float32),
        # free-flow travel time divided BEFORE the f32 cast: in the
        # reference's free-flow FD branch the speed stays a Python float
        # (functions.py:120-121), so length/speed divides in f64
        "tt_freeflow32": (length / free_flow_speed).astype(xp.float32),
        "free_flow_tau": fftau,
        "tau_shockwave": tau_shock,
    }


class Scenario:
    """Static scenario container.

    Holds device constants (index tensors, static per-link lookbacks) as
    attributes; jitted step functions close over a Scenario instance.
    Dynamic, randomizable parameters live in :class:`EngineParams` so
    batched envs can vmap over them.
    """

    def __init__(
        self,
        topo: TopologySpec,
        params: dict,
        origin_nodes: List[int],
        destination_nodes: List[int],
        engine_params: EngineParams,
        routing: Optional[RoutingTables],
        path_builder: Optional[PathSetBuilder],
        od_manager: Optional[ODManager],
        pos: Optional[dict] = None,
        ftype=jnp.float32,
        exact_parity: bool = False,
        history_window: Optional[int] = None,
        binomial_mode: str = "exact",
        track_inflow_ring: bool = True,
    ):
        self.exact_parity = exact_parity
        self.history_window = history_window
        self.binomial_mode = binomial_mode
        # the stochastic fast path reconstructs the diffusion taps from
        # cum_in differences (ops/ncurve.py) and never reads the inflow
        # ring in-loop; its per-step row write is pure diagnostic state
        # (host-side consumers like rl/optimization_based.py read it from
        # the final state).  track_inflow_ring=False skips maintaining it
        # on that path — dynamics are unchanged; state.inflow_ring stays
        # zeros.  The flag is ignored (ring always maintained) whenever
        # some in-loop reader needs it: exact-parity or deterministic
        # mode.
        self.track_inflow_ring = track_inflow_ring
        self.topo = topo
        self.params = params
        self.origin_nodes = list(origin_nodes)
        self.destination_nodes = list(destination_nodes or [])
        self.pos = pos
        self.ftype = ftype
        self.path_builder = path_builder
        self.od_manager = od_manager
        self.routing = routing

        self.simulation_steps = int(params["simulation_steps"])
        self.unit_time = float(params["unit_time"])
        self.assign_flows_type = params.get("assign_flows_type", "classic")
        self.big_m = 1e6  # destination virtual receiving flow (node.py:22)

        lp = topo.link_params
        self.n_nodes = topo.n_nodes
        self.n_links = topo.n_links
        self.max_deg = topo.max_deg

        # static index tensors — kept as NumPy so jitted closures embed
        # them as backend-independent constants (no device round-trips at
        # trace time; a scenario built while one backend is unhealthy or
        # before a backend switch stays usable)
        self.reverse_idx = np.asarray(topo.reverse_idx)
        self.in_link_idx = np.asarray(topo.in_link_idx)
        self.out_link_idx = np.asarray(topo.out_link_idx)
        self.slot_valid = np.asarray(topo.slot_valid)
        self.has_virtual = np.asarray(topo.has_virtual)
        self.is_otoo = np.asarray(topo.is_otoo)
        self.node_arity = np.asarray(topo.node_arity)
        self.end_node = np.asarray(topo.end_node)
        self.end_slot = np.asarray(topo.end_slot)
        self.start_node = np.asarray(topo.start_node)
        self.start_slot = np.asarray(topo.start_slot)
        self.is_separator = np.asarray(lp.is_separator)
        self.fd_type = np.asarray(lp.fd_type)

        # static per-link derived quantities (nominal values; the engine
        # reads the per-replica copies carried in EngineParams so domain
        # randomization stays self-consistent)
        derived = derive_link_constants(
            lp.length, lp.free_flow_speed, lp.k_critical, lp.k_jam,
            self.unit_time,
        )
        self.max_travel_time = derived["max_travel_time"]
        self.travel_time0 = derived["travel_time0"]
        self.tt_freeflow32 = derived["tt_freeflow32"]
        self.free_flow_tau = derived["free_flow_tau"]
        self.tau_shockwave = derived["tau_shockwave"]

        # N-curve history horizon.  The dynamic lookback tau =
        # round(avg_travel_time / unit_time) (link.py:260) is UNBOUNDED in
        # the reference — travel_time = length/speed is only clamped when
        # speed == 0 (link.py:177), so a nearly-jammed link can produce
        # arbitrarily large tau.  Full-horizon buffers (H = T+1) reproduce
        # the reference exactly; O(E*T) HBM is fine for T <= a few
        # thousand.  ``history_window`` selects a windowed-ring mode that
        # clamps tau to the window (a modeling choice: bounded congestion
        # memory) and cuts both memory and ring-read traffic — the fast mode
        # for batched RL training.
        T = self.simulation_steps
        if history_window is not None:
            if history_window < 16:
                raise ValueError("history_window must be >= 16")
            self.H = int(min(history_window, T + 1))
        else:
            self.H = T + 1
        self.avg_tt_window = int(round(100 / self.unit_time))  # link.py:89

        self.engine_params = engine_params

        self.optimal_solver = None
        if self.assign_flows_type == "optimal":
            from .lp_solver import OptimalNodeSolver

            self.optimal_solver = OptimalNodeSolver(topo)

    # -- state factory ------------------------------------------------------

    def init_state(self, key: Optional[jax.Array] = None) -> NetworkState:
        f = self.ftype
        f32 = jnp.float32
        E, N, H, W = self.n_links, self.n_nodes, self.H, self.avg_tt_window
        if key is None:
            key = jax.random.PRNGKey(0)

        lp = self.topo.link_params
        width = jnp.asarray(lp.width, dtype=f)
        is_sep = self.is_separator

        # rings are time-major [H, E] — see ops/ncurve.py layout rationale
        tt_ring = jnp.broadcast_to(self.travel_time0[None, :], (W, E)).astype(f32)

        return NetworkState(
            t=jnp.asarray(1, dtype=jnp.int32),
            key=key,
            cum_in_ring=jnp.zeros((H, E), dtype=f),
            cum_out_ring=jnp.zeros((H, E), dtype=f),
            inflow_ring=jnp.zeros((H, E), dtype=f),
            tt_ring=tt_ring,
            cum_in=jnp.zeros(E, dtype=f),
            cum_out=jnp.zeros(E, dtype=f),
            inflow=jnp.zeros(E, dtype=f),
            outflow=jnp.zeros(E, dtype=f),
            num_peds=jnp.zeros(E, dtype=f32),
            density=jnp.zeros(E, dtype=f32),
            speed=jnp.zeros(E, dtype=f32),
            travel_time=jnp.asarray(self.travel_time0),
            link_flow=jnp.zeros(E, dtype=f32),
            avg_tt=jnp.asarray(self.travel_time0),
            tt_run_sum=jnp.asarray(self.travel_time0),
            sending_prev=-jnp.ones(E, dtype=f),  # -1 sentinel (link.py:16)
            recv_prev=-jnp.ones(E, dtype=f),  # -1 sentinel (link.py:17)
            back_gate=jnp.where(is_sep, width / 2, width),  # link.py:55-56,423-424
            sep_width=jnp.where(is_sep, width / 2, width),
            virt_dep=jnp.zeros(N, dtype=f),
            virt_arr=jnp.zeros(N, dtype=f),
            virt_dep_cum=jnp.zeros(N, dtype=f),
            virt_arr_cum=jnp.zeros(N, dtype=f),
        )


def _build_phi_base(topo: TopologySpec, ftype) -> jnp.ndarray:
    """Equal turning fractions 1/(dest_num-1) off-diagonal
    (network.py:269-271)."""
    N, M = topo.n_nodes, topo.max_deg
    eye = np.eye(M, dtype=bool)
    valid = topo.slot_valid[:, :, None] & topo.slot_valid[:, None, :] & ~eye[None]
    m = topo.node_arity.astype(np.float64)
    inv = 1.0 / np.maximum(m - 1.0, 1.0)
    phi = np.where(valid, inv[:, None, None], 0.0)
    return np.asarray(phi, dtype=np.dtype(ftype))


def build_scenario(
    adjacency_matrix: np.ndarray,
    params: dict,
    origin_nodes: List[int],
    destination_nodes: Optional[List[int]] = None,
    od_flows: Optional[dict] = None,
    demand_pattern: Optional[List[Callable]] = None,
    pos: Optional[dict] = None,
    ftype=jnp.float32,
    exact_parity: bool = False,
    history_window: Optional[int] = None,
    binomial_mode: str = "exact",
    track_inflow_ring: bool = True,
    od_candidates: Optional[Tuple[List[int], List[int]]] = None,
) -> Scenario:
    """Compile a scenario (reference Network.__init__, network.py:56-121).

    demand_pattern: optional list of custom demand callables registered by
    __name__ (network.py:88-93).

    od_candidates: optional ``(candidate_origins, candidate_destinations)``
    for in-vmap OD-node randomization.  The topology, demand curves, and
    routing tables are built over the UNION of nominal and candidate OD
    nodes, but candidate nodes start INACTIVE (zero demand row, zero
    od_table rows, zero virtual receiving) — per-replica activation rides
    EngineParams (pednstream_tpu.randomize), replacing the reference's
    host-side network rebuild per episode (env_loader.py:261-359).
    Note the nominal dynamics are a close approximation, not bit-equal,
    to the plain build: candidate nodes carry inert virtual links and
    extra zero-flow routing paths.
    """
    destination_nodes = destination_nodes or []
    cand_origins: List[int] = []
    cand_dests: List[int] = []
    if od_candidates is not None:
        cand_origins = [n for n in od_candidates[0] if n not in origin_nodes]
        cand_dests = [n for n in od_candidates[1] if n not in destination_nodes]
    origins_eff = list(origin_nodes) + cand_origins
    dests_eff = list(destination_nodes) + cand_dests
    topo = build_topology(adjacency_matrix, params, origins_eff, dests_eff)

    # demand curves, generated in node-creation order for RNG parity.
    # Candidate origins draw from a SEPARATE seeded pass so the nominal
    # origins' curves stay identical to the plain build.
    T = int(params["simulation_steps"])
    virtual_nodes = [n for n in topo.node_creation_order if topo.has_virtual[n]]
    custom = {f.__name__: f for f in (demand_pattern or [])}
    demands = build_demand_table(T, params, list(origin_nodes), virtual_nodes, custom)
    if cand_origins:
        params_cand = dict(params)
        params_cand["seed"] = int(params.get("seed") or 0) + 10007
        demands_cand = build_demand_table(
            T, params_cand, cand_origins, virtual_nodes, custom
        )
        for node_id in cand_origins:
            if node_id in demands_cand:
                demands[node_id] = demands_cand[node_id]
    demand_table = np.zeros((topo.n_nodes, T + 1), dtype=np.float64)
    for node_id, arr in demands.items():
        demand_table[node_id, : len(arr)] = arr[: T + 1]

    od_manager = None
    routing = None
    builder = None
    od_pairs: List[Tuple[int, int]] = []
    od_table = np.zeros((0, T + 1), dtype=np.float64)
    if dests_eff:
        od_manager = ODManager(T)
        od_manager.init_od_flows(origins_eff, dests_eff, od_flows)
        od_pairs, od_table = od_manager.dense_table()

        _, controller_nodes, _, controller_links = parse_controllers(params)
        builder = PathSetBuilder(topo, params, controller_nodes, controller_links)
        builder.find_od_paths(od_pairs)
        routing = build_routing_tables(topo, builder, od_pairs)

    lp = topo.link_params
    npdt = np.dtype(ftype)
    unit_time = float(params["unit_time"])
    derived = derive_link_constants(
        lp.length, lp.free_flow_speed, lp.k_critical, lp.k_jam, unit_time
    )

    # nominal OD activation: candidates start closed (demand, od rows,
    # virtual receiving all zero) — randomize.py opens them per replica
    N = topo.n_nodes
    nominal_o = np.zeros(N, dtype=bool)
    nominal_o[list(origin_nodes)] = True
    nominal_d = np.zeros(N, dtype=bool)
    if destination_nodes:
        nominal_d[list(destination_nodes)] = True
    demand_full = demand_table.copy()
    demand_nominal = demand_table * nominal_o[:, None]
    od_po = np.asarray([p[0] for p in od_pairs], dtype=np.int64)
    od_pd = np.asarray([p[1] for p in od_pairs], dtype=np.int64)
    if len(od_pairs):
        pair_nominal = nominal_o[od_po] & nominal_d[od_pd]
        od_table_nominal = od_table * pair_nominal[:, None]
    else:
        od_table_nominal = od_table
    virt_recv = np.where(
        np.asarray(topo.has_virtual) & (nominal_o | nominal_d), 1e6, 0.0
    )
    if od_candidates is None:
        # plain build: every virtual-link node keeps its big-M slot
        # (bit-equal to the pre-virt_recv behavior, node.py:187)
        virt_recv = np.where(np.asarray(topo.has_virtual), 1e6, 0.0)
        demand_nominal = demand_table
        od_table_nominal = od_table

    ep = EngineParams(
        length=np.asarray(lp.length, dtype=npdt),
        width=np.asarray(lp.width, dtype=npdt),
        free_flow_speed=np.asarray(lp.free_flow_speed, dtype=npdt),
        k_critical=np.asarray(lp.k_critical, dtype=npdt),
        k_jam=np.asarray(lp.k_jam, dtype=npdt),
        gamma=np.asarray(lp.gamma, dtype=npdt),
        bi_factor=np.asarray(lp.bi_factor, dtype=npdt),
        activity_probability=np.asarray(lp.activity_probability, dtype=npdt),
        speed_noise_std=np.asarray(lp.speed_noise_std, dtype=npdt),
        demand=np.asarray(demand_nominal, dtype=npdt),
        od_table=np.asarray(od_table_nominal, dtype=npdt),
        phi_base=np.asarray(_build_phi_base(topo, ftype)),
        virt_recv=np.asarray(virt_recv, dtype=npdt),
        max_travel_time=derived["max_travel_time"],
        travel_time0=derived["travel_time0"],
        tt_freeflow32=derived["tt_freeflow32"],
        free_flow_tau=derived["free_flow_tau"],
        tau_shockwave=derived["tau_shockwave"],
    )

    scn = Scenario(
        topo=topo,
        params=params,
        origin_nodes=list(origin_nodes),
        destination_nodes=list(destination_nodes),
        engine_params=ep,
        routing=routing,
        path_builder=builder,
        od_manager=od_manager,
        pos=pos,
        ftype=ftype,
        exact_parity=exact_parity,
        history_window=history_window,
        binomial_mode=binomial_mode,
        track_inflow_ring=track_inflow_ring,
    )
    # in-vmap OD-node randomization metadata (see randomize.py)
    scn.od_randomizable = od_candidates is not None
    if scn.od_randomizable:
        cand_o_mask = np.zeros(N, dtype=bool)
        cand_o_mask[cand_origins] = True
        cand_d_mask = np.zeros(N, dtype=bool)
        cand_d_mask[cand_dests] = True
        scn.nominal_origin_mask = nominal_o
        scn.nominal_dest_mask = nominal_d
        scn.candidate_origin_mask = cand_o_mask
        scn.candidate_dest_mask = cand_d_mask
        scn.demand_full = demand_full
        scn.od_pair_origin = od_po
        scn.od_pair_dest = od_pd
        scn.od_table_full = od_table
    return scn
