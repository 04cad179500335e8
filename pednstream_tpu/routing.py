"""Route choice: host-side path/turn-table precompute + on-device logit
turning fractions.

The reference PathFinder (src/LTM/path_finder.py) enumerates k shortest
simple paths per OD pair (path_finder.py:114-142,199-234), expands detour
paths at controller nodes (:304-458), and each step recomputes per-node
logit turn probabilities (:561-589) mixed with OD flow shares (:591-689).

Host/device split:
  * everything topological (path enumeration, controller expansion, turn
    distance tables, OD->upstream assignments) is compiled ON HOST at
    scenario build time into flat "turn entry" / "(up, od) entry" tensors
    with segment ids;
  * the per-step dynamic part (logit softmax over congestion/capacity,
    P(od|up) flow mixing, row-normalization guard of :691-715) is pure
    segment arithmetic on device — O(K) with K = total turn entries.
"""

from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import paths as nxp
from .ops.division import div
from .pytree import pytree_dataclass, static_field
from .topology import TopologySpec


# --------------------------------------------------------------------------
# Host-side: path enumeration and static turn tables
# --------------------------------------------------------------------------

def enumerate_shortest_simple_paths(graph, origin, dest, max_paths=None):
    """K shortest simple paths by total weight (path_finder.py:114-142)."""
    paths = []
    try:
        for path in nxp.shortest_simple_paths(graph, origin, dest):
            paths.append(path)
            if max_paths is not None and len(paths) >= max_paths:
                break
    except nxp.NoPath:
        return []
    return paths


class PathSetBuilder:
    """Host path enumeration with controller detour expansion.

    Mirrors PathFinder.find_od_paths / expand_controller_paths
    (path_finder.py:199-458) with the hardcoded detour settings
    ('penalize' mode, penalty factor 2, max 3 detour paths per neighbour,
    path_finder.py:172-175).
    """

    def __init__(
        self,
        topo: TopologySpec,
        params: Optional[dict],
        controller_nodes: Optional[Set[int]],
        controller_links: Optional[List[str]],
    ):
        path_params = (params or {}).get("path_finder", {}) or {}
        self.k_paths = path_params.get("k_paths", 3)
        self.temp = path_params.get("temp", 0.1)
        self.alpha = path_params.get("alpha", 1.0)
        self.beta = path_params.get("beta", 0.05)
        self.omega = path_params.get("omega", 0.05)
        self.std_dev = path_params.get("std_dev", 0)
        self.detour_penalty_factor = 2
        self.max_detour_paths = 3

        self.topo = topo
        self.controller_nodes = set(controller_nodes or set())
        self.controllers_enabled = bool(controller_nodes or controller_links)

        self.graph = nxp.DiGraph()
        for e, (u, v) in enumerate(topo.link_nodes):
            self.graph.add_edge(int(u), int(v), float(topo.link_params.length[e]))

        self.od_paths: Dict[Tuple[int, int], List[List[int]]] = {}
        self.nodes_in_paths: Set[int] = set()
        self.node_to_od_pairs: Dict[int, Set[Tuple[int, int]]] = {}

    def find_od_paths(self, od_pairs) -> None:
        for origin, dest in od_pairs:
            paths = enumerate_shortest_simple_paths(
                self.graph, origin, dest, max_paths=self.k_paths
            )
            self.od_paths[(origin, dest)] = paths
            for path in paths:
                for node in path:
                    self.nodes_in_paths.add(node)
                    self.node_to_od_pairs.setdefault(node, set()).add((origin, dest))

        if self.controllers_enabled:
            for node in sorted(self.controller_nodes):
                for od_pair in sorted(self.node_to_od_pairs.get(node, set())):
                    self._expand_controller_paths(node, od_pair)

        # dedup (path_finder.py:236-254)
        for od_pair, paths in self.od_paths.items():
            normalized = [tuple(int(x) for x in p) for p in paths]
            if len(set(normalized)) != len(normalized):
                seen, unique = set(), []
                for p in normalized:
                    if p not in seen:
                        seen.add(p)
                        unique.append(list(p))
                self.od_paths[od_pair] = unique

    def _outgoing_neighbors(self, node_id: int) -> Set[int]:
        k0 = 1 if self.topo.has_virtual[node_id] else 0
        return {
            int(m)
            for m in self.topo.slot_neighbor[node_id, k0:]
            if int(m) >= 0
        }

    def _expand_controller_paths(self, node_id: int, od_pair) -> None:
        """Detour expansion at a controller node (path_finder.py:304-458)."""
        origin, dest = od_pair
        paths = self.od_paths[od_pair]
        new_paths: List[List[int]] = []

        all_outgoing = self._outgoing_neighbors(node_id)

        modified = self.graph.copy()
        all_od_edges: Dict[Tuple[int, int], float] = {}
        for p in paths:
            for i in range(len(p) - 1):
                edge = (p[i], p[i + 1])
                if edge not in all_od_edges:
                    try:
                        all_od_edges[edge] = nxp.shortest_path_length(
                            self.graph, p[i + 1], dest
                        )
                    except nxp.NoPath:
                        all_od_edges[edge] = 0
        if all_od_edges:
            max_dist = max(all_od_edges.values())
            for (u, v), dist_to_dest in all_od_edges.items():
                if modified.has_edge(u, v):
                    if max_dist > 0:
                        dyn = 1.0 + (self.detour_penalty_factor - 1.0) * (
                            dist_to_dest / max_dist
                        )
                    else:
                        dyn = self.detour_penalty_factor
                    modified.weight[(u, v)] = modified.weight[(u, v)] * dyn

        for path in paths:
            if node_id not in path:
                continue
            node_idx = path.index(node_id)
            if node_id == dest:
                continue
            up_node = -1 if node_id == origin else (path[node_idx - 1] if node_idx > 0 else -1)
            on_path_down = path[node_idx + 1] if node_idx < len(path) - 1 else None

            for neighbor in all_outgoing:
                if neighbor == on_path_down or neighbor == up_node:
                    continue
                if neighbor in set(path[:node_idx]):
                    continue
                detours = enumerate_shortest_simple_paths(
                    modified, neighbor, dest, max_paths=self.max_detour_paths
                )
                if not detours:
                    continue
                prefix_and_current = set(path[: node_idx + 1])
                for suffix in detours:
                    if set(suffix[1:]) & prefix_and_current:
                        continue
                    new_path = path[: node_idx + 1] + suffix
                    existing = set(tuple(p) for p in self.od_paths[od_pair])
                    if tuple(new_path) not in existing:
                        new_paths.append(new_path)

        if new_paths:
            self.od_paths[od_pair].extend(new_paths)
            for new_path in new_paths:
                for node in new_path:
                    self.nodes_in_paths.add(node)
                    self.node_to_od_pairs.setdefault(node, set()).add(od_pair)

    def path_distance(self, path, start_idx=0) -> float:
        """Remaining distance along path (path_finder.py:284-300)."""
        dist = 0.0
        for i in range(start_idx, len(path) - 1):
            dist += self.graph.weight[(path[i], path[i + 1])]
        return dist


@pytree_dataclass
class RoutingTables:
    """Flat device tables for the per-step turning-fraction update.

    K turn entries, one per (node, od, up, down) candidate turn; U
    "(node, up, od)" entries for the P(od|up) flow mixing; G softmax
    groups over (node, od, up); UG groups over (node, up).
    """

    # turn entries [K]
    te_dist: jnp.ndarray  # float, remaining distance of the turn
    te_group: jnp.ndarray  # int, (node, od, up) softmax group id
    te_uo_idx: jnp.ndarray  # int, index into uo entries
    te_down_link: jnp.ndarray  # int, directed link id of (node -> down), -1 virtual
    te_phi_idx: jnp.ndarray  # int, node*M*M + up_slot*M + down_slot
    group_dist_sum: jnp.ndarray  # [G] static sum of distances per softmax group

    # (node, up, od) entries [U]
    uo_od: jnp.ndarray  # int, od pair index
    uo_group: jnp.ndarray  # int, (node, up) group id
    uo_group_count: jnp.ndarray  # [UG] entries per group

    routed_mask: jnp.ndarray  # [N] bool: node has dynamic turning fractions

    # logit parameters (scalars)
    temp: jnp.ndarray
    alpha: jnp.ndarray
    beta: jnp.ndarray
    omega: jnp.ndarray

    # static one-hot aggregation matrices: the fast path sums segments
    # with small matmuls against these (exact-parity keeps segment_sum's
    # summation order).  The phi scatter goes through a COMPACT slot
    # space over the NR routed nodes only: a direct [K, N*M*M] one-hot
    # is 99 MB on grid_50x50 (2,500 nodes) for 460 live columns; the
    # compact pair is ~6 MB and the densify matmul has exactly one
    # nonzero per output column, so the result is bitwise identical.
    onehot_te_group: jnp.ndarray  # [K, G]
    onehot_uo_group: jnp.ndarray  # [U, UG]
    onehot_phi_c: jnp.ndarray  # [K, NR*M*M] compact phi scatter
    onehot_densify: jnp.ndarray  # [NR, N] compact row -> dense node row
    routed_ids: jnp.ndarray  # [NR] int32, sorted routed node ids

    num_groups: int = static_field()
    num_uo_groups: int = static_field()
    num_entries: int = static_field()
    num_routed: int = static_field()


def build_routing_tables(
    topo: TopologySpec,
    builder: PathSetBuilder,
    od_pairs: List[Tuple[int, int]],
) -> Optional[RoutingTables]:
    """Compile turn tables from enumerated paths.

    Mirrors PathFinder.calculate_turn_probabilities (path_finder.py:460-559):
    per routed node (source_num > 2 and on some path), for each relevant OD
    pair, each (up, down) turn keeps the *shortest* remaining distance over
    all paths realizing it; ods_in_turns / up_od_probs record which OD pairs
    use each turn / upstream arm.
    """
    od_index = {p: i for i, p in enumerate(od_pairs)}
    nb2slot = topo.neighbor_to_slot
    M = topo.max_deg

    # per node: turns_distances[od][up][down] = dist
    te_rows = []  # (node, od_idx, up, down, dist)
    routed_nodes = []
    for node_id in sorted(builder.nodes_in_paths):
        if int(topo.node_arity[node_id]) <= 2:
            continue
        relevant = builder.node_to_od_pairs.get(node_id, set())
        node_turns: Dict[Tuple[int, int], Dict[Tuple[int, int], float]] = {}
        for od_pair in relevant:
            origin, dest = od_pair
            od_turn_distances: Dict[Tuple[int, int], float] = {}
            for path in builder.od_paths[od_pair]:
                if node_id not in path:
                    continue
                node_idx = path.index(node_id)
                if node_id == origin:
                    turn = (-1, path[node_idx + 1])
                elif node_id == dest:
                    turn = (path[node_idx - 1], -1)
                elif node_idx < len(path) - 1:
                    turn = (path[node_idx - 1], path[node_idx + 1])
                else:
                    continue
                remaining = builder.path_distance(path, start_idx=node_idx)
                if turn not in od_turn_distances or remaining < od_turn_distances[turn]:
                    od_turn_distances[turn] = remaining
            if od_turn_distances:
                node_turns[od_pair] = od_turn_distances
        if not node_turns:
            continue
        routed_nodes.append(node_id)
        for od_pair, turns in node_turns.items():
            for (up, down), dist in turns.items():
                te_rows.append((node_id, od_index[od_pair], up, down, dist))

    if not te_rows:
        return None

    # softmax groups: (node, od, up); uo groups: (node, up)
    group_ids: Dict[Tuple[int, int, int], int] = {}
    uo_entry_ids: Dict[Tuple[int, int, int], int] = {}  # (node, up, od) -> entry
    uo_group_ids: Dict[Tuple[int, int], int] = {}

    te_dist, te_group, te_uo_idx, te_down_link, te_phi_idx = [], [], [], [], []
    uo_od_l, uo_group_l = [], []

    for (node_id, od_i, up, down, dist) in te_rows:
        gkey = (node_id, od_i, up)
        if gkey not in group_ids:
            group_ids[gkey] = len(group_ids)
        uekey = (node_id, up, od_i)
        if uekey not in uo_entry_ids:
            uo_entry_ids[uekey] = len(uo_entry_ids)
            ugkey = (node_id, up)
            if ugkey not in uo_group_ids:
                uo_group_ids[ugkey] = len(uo_group_ids)
            uo_od_l.append(od_i)
            uo_group_l.append(uo_group_ids[ugkey])

        up_slot = nb2slot[node_id][up]
        down_slot = nb2slot[node_id][down]
        if down == -1:
            dlink = -1
        else:
            dlink = topo.link_id_to_idx[(node_id, down)]
        te_dist.append(dist)
        te_group.append(group_ids[gkey])
        te_uo_idx.append(uo_entry_ids[uekey])
        te_down_link.append(dlink)
        te_phi_idx.append(node_id * M * M + up_slot * M + down_slot)

    G = len(group_ids)
    UG = len(uo_group_ids)
    te_dist = np.array(te_dist, dtype=np.float64)
    te_group = np.array(te_group, dtype=np.int32)
    group_dist_sum = np.zeros(G, dtype=np.float64)
    np.add.at(group_dist_sum, te_group, te_dist)
    uo_group_arr = np.array(uo_group_l, dtype=np.int32)
    uo_group_count = np.zeros(UG, dtype=np.float64)
    np.add.at(uo_group_count, uo_group_arr, 1.0)

    routed_mask = np.zeros(topo.n_nodes, dtype=bool)
    routed_mask[routed_nodes] = True

    K = len(te_rows)
    te_group_arr = np.asarray(te_group)
    onehot_te_group = np.zeros((K, G), dtype=np.float32)
    onehot_te_group[np.arange(K), te_group_arr] = 1.0
    U = len(uo_od_l)
    onehot_uo_group = np.zeros((U, UG), dtype=np.float32)
    onehot_uo_group[np.arange(U), uo_group_arr] = 1.0
    # compact phi scatter: column space is (routed node, up, down) only
    routed_arr = np.array(routed_nodes, dtype=np.int32)  # sorted by build
    NR = len(routed_arr)
    node_to_c = {int(n): i for i, n in enumerate(routed_arr)}
    phi_idx_arr = np.array(te_phi_idx, dtype=np.int64)
    c_cols = np.array(
        [node_to_c[int(p // (M * M))] * M * M + int(p % (M * M))
         for p in phi_idx_arr], dtype=np.int64)
    onehot_phi_c = np.zeros((K, NR * M * M), dtype=np.float32)
    onehot_phi_c[np.arange(K), c_cols] = 1.0
    onehot_densify = np.zeros((NR, topo.n_nodes), dtype=np.float32)
    onehot_densify[np.arange(NR), routed_arr] = 1.0

    return RoutingTables(
        te_dist=te_dist,
        te_group=te_group,
        te_uo_idx=np.array(te_uo_idx, dtype=np.int32),
        te_down_link=np.array(te_down_link, dtype=np.int32),
        te_phi_idx=np.array(te_phi_idx, dtype=np.int32),
        group_dist_sum=group_dist_sum,
        uo_od=np.array(uo_od_l, dtype=np.int32),
        uo_group=uo_group_arr,
        uo_group_count=uo_group_count,
        routed_mask=routed_mask,
        temp=np.float64(builder.temp),
        alpha=np.float64(builder.alpha),
        beta=np.float64(builder.beta),
        omega=np.float64(builder.omega),
        onehot_te_group=onehot_te_group,
        onehot_uo_group=onehot_uo_group,
        onehot_phi_c=onehot_phi_c,
        onehot_densify=onehot_densify,
        routed_ids=routed_arr,
        num_groups=G,
        num_uo_groups=UG,
        num_entries=len(te_rows),
        num_routed=NR,
    )


# --------------------------------------------------------------------------
# Device-side per-step turning fractions
# --------------------------------------------------------------------------

def turning_fractions_step(
    rt: RoutingTables,
    n_nodes: int,
    max_deg: int,
    node_arity,  # [N]
    slot_valid,  # [N, M]
    density_for_routing,  # [E] = link.get_density(t-1)
    recv_prev,  # [E] receiving_flow[t-2], -1 sentinel if unset
    cap_default,  # [E] back_gate * v_f * k_c * dt (path_finder.py:576)
    od_flow_t,  # [P] od flows at time t
    phi_base,  # [N, M, M] static equal fractions
    exact: bool = True,
    compact: bool = False,
):
    """Compute phi[N, M, M] turning fractions for this step.

    phi[n, i, j] = P(outgoing slot j | incoming slot i) for routed nodes,
    assembled as sum over OD pairs of P(down|up,od) * P(od|up)
    (path_finder.py:591-689), then passed through the row-normalization
    guard (path_finder.py:691-715).  Non-routed nodes keep phi_base.
    """
    f = phi_base.dtype
    f32 = jnp.float32

    def seg(vals, seg_ids, num, onehot):
        # exact-parity keeps segment_sum's accumulation order; the fast
        # path aggregates with a static one-hot matmul.  HIGHEST keeps the
        # f32 operands whole: the default GPU precision may run the
        # product in TF32 (~3 decimal digits), which would perturb the
        # logit normalizers on every routed step
        if exact:
            return jax.ops.segment_sum(vals, seg_ids, num_segments=num)
        return jnp.matmul(vals, onehot.astype(vals.dtype),
                          precision=jax.lax.Precision.HIGHEST)

    # P(od | up): od-flow-weighted shares per (node, up) group
    # (path_finder.py:599-615)
    w = od_flow_t[rt.uo_od].astype(f)
    tot = seg(w, rt.uo_group, rt.num_uo_groups, rt.onehot_uo_group)
    tot_g = tot[rt.uo_group]
    cnt_g = rt.uo_group_count[rt.uo_group].astype(f)
    p_uo = jnp.where(tot_g > 0, div(w, jnp.where(tot_g > 0, tot_g, 1.0)), div(1.0, cnt_g))

    # P(down | up, od): logit over candidate turns of each (node, od, up).
    # Dtype staging mirrors path_finder.py:561-589: densities are f32
    # state, beta * norm_densities stays f32, everything else f64-ish.
    ld = rt.te_down_link
    safe = jnp.maximum(ld, 0)
    dens32 = jnp.where(ld >= 0, density_for_routing[safe].astype(f32), f32(0.0))
    rp = recv_prev[safe]
    cap = jnp.where(
        ld >= 0,
        jnp.where(rp >= 0, rp, cap_default[safe]),
        100.0,  # virtual exits get high capacity (path_finder.py:577-579)
    ).astype(f)
    norm_d32 = div(jnp.maximum(dens32 - f32(2.0), f32(0.0)), f32(10.0 - 2.0))  # :581
    cap_sum = seg(cap, rt.te_group, rt.num_groups, rt.onehot_te_group)
    te_dist = rt.te_dist.astype(f)
    util = (
        div(rt.alpha.astype(f) * te_dist, rt.group_dist_sum[rt.te_group].astype(f) + 1e-6)
        + (rt.beta.astype(f32) * norm_d32).astype(f)
        - div(rt.omega.astype(f) * cap, cap_sum[rt.te_group] + 1e-6)
    )
    z = jnp.exp(-rt.temp.astype(f) * util)
    zsum = seg(z, rt.te_group, rt.num_groups, rt.onehot_te_group)
    p_turn = div(z, zsum[rt.te_group])

    contrib = p_turn * p_uo[rt.te_uo_idx]

    def guard(phi, sv, arity):
        # row-normalization guard (check_fractions, path_finder.py:691-715)
        # over an arbitrary node axis (dense [N] or compact [NR])
        eye = jnp.eye(max_deg, dtype=bool)
        offdiag_valid = sv[:, :, None] & sv[:, None, :] & ~eye[None]
        rowsum = phi.sum(axis=-1)
        inv = div(1.0, jnp.maximum(arity.astype(f) - 1.0, 1.0))[:, None, None]
        uniform = jnp.where(offdiag_valid, inv, 0.0)
        need_fix = jnp.abs(rowsum - 1.0) > 1e-3
        rs_safe = jnp.where(rowsum > 1e-6, rowsum, 1.0)
        phi_norm = div(phi, rs_safe[:, :, None])
        return jnp.where(
            (need_fix & (rowsum > 1e-6))[:, :, None],
            phi_norm,
            jnp.where((need_fix & ~(rowsum > 1e-6))[:, :, None], uniform, phi),
        )

    if exact:
        phi_flat = jax.ops.segment_sum(
            contrib, rt.te_phi_idx, num_segments=n_nodes * max_deg * max_deg
        )
        phi = phi_flat.reshape(n_nodes, max_deg, max_deg)
        phi_fixed = guard(phi, slot_valid, node_arity)
    else:
        # compact path: assemble + guard phi only for the NR routed nodes,
        # then densify with a one-nonzero-per-column 0/1 matmul — bitwise
        # identical to the dense [K, N*M*M] scatter-matmul (x*1 + 0*y == x
        # for these finite non-negative values) at a fraction of the HBM
        # traffic and matmul work.  precision=HIGHEST: a reduced-precision
        # default (TF32 on the GPU) would round phi to ~3 decimal digits
        hi = jax.lax.Precision.HIGHEST
        phi_c = jnp.matmul(contrib, rt.onehot_phi_c.astype(contrib.dtype),
                           precision=hi).reshape(rt.num_routed, max_deg, max_deg)
        phi_fixed_c = guard(phi_c, slot_valid[rt.routed_ids],
                            node_arity[rt.routed_ids])
        if compact:
            # caller (engine._node_solve) solves routed nodes directly on
            # the compact rows and never materializes a batched dense phi
            return phi_fixed_c
        phi_fixed = jnp.einsum("rn,rij->nij",
                               rt.onehot_densify.astype(f), phi_fixed_c,
                               precision=hi)
    return jnp.where(rt.routed_mask[:, None, None], phi_fixed, phi_base)
