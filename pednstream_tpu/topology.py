"""Scenario compiler: adjacency matrix -> static struct-of-arrays topology.

The reference builds an object graph of Node/Link instances
(src/LTM/network.py:194-248, node.py:6-64).  The array engine instead needs
static index tensors.  This module compiles:

  - directed link list in reference creation order (upper-triangle corridor
    scan, forward then reverse per corridor), with ``reverse_idx`` the
    reverse-link permutation replacing ``link.reverse_link`` pointers
    (link.py:99, network.py:245-246);
  - padded node-link incidence: ``in_link_idx[N, M]`` / ``out_link_idx[N, M]``
    where slot 0 is the virtual origin/destination link when present
    (node.py:28-42; virtual links are appended at node creation, before any
    real link, so they always occupy slot 0), and real links follow in
    ascending-neighbour order (a consequence of the i<j corridor scan);
  - node typing by degree (network.py:141-167): OneToOne vs Regular and
    which nodes carry virtual links;
  - per-link physical parameters resolved from default_link/links overrides
    (network.py:169-192) including the Separator flag for controller links
    (network.py:216-234).

Node-slot invariant exploited everywhere downstream: incoming slot k and
outgoing slot k of a node connect to the *same* neighbour (or the virtual
pair at slot 0), because both directions of a corridor are appended to the
node's lists at the same moment (network.py:236-240).  This is what makes
the reference's OneToOneNode crossing rule (node.py:230-242) and the
``up == down`` U-turn exclusion (path_finder.py:669-671, node.py:50-52)
slot-index-aligned.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

FD_TYPES = {"greenshields": 0, "yperman": 1, "smulders": 2}


@dataclass
class LinkParamArrays:
    """Per-directed-link physical parameters (E-length float arrays)."""

    length: np.ndarray
    width: np.ndarray
    free_flow_speed: np.ndarray
    k_critical: np.ndarray
    k_jam: np.ndarray
    gamma: np.ndarray
    bi_factor: np.ndarray
    activity_probability: np.ndarray
    speed_noise_std: np.ndarray
    fd_type: np.ndarray  # int codes, FD_TYPES
    is_separator: np.ndarray  # bool


@dataclass
class TopologySpec:
    """Static compiled topology."""

    n_nodes: int
    n_links: int  # E, directed
    max_deg: int  # M, max node degree incl. virtual slot

    # directed links
    link_nodes: np.ndarray  # [E, 2] (u, v)
    reverse_idx: np.ndarray  # [E]
    link_params: LinkParamArrays

    # node incidence (padded with -1)
    in_link_idx: np.ndarray  # [N, M]; -1 = virtual or pad
    out_link_idx: np.ndarray  # [N, M]
    slot_valid: np.ndarray  # [N, M] bool (slot < node arity)
    slot_neighbor: np.ndarray  # [N, M] neighbour node id, -1 for virtual, -2 pad
    node_arity: np.ndarray  # [N] = source_num = dest_num (square nodes)
    has_virtual: np.ndarray  # [N] bool
    is_otoo: np.ndarray  # [N] bool (OneToOneNode)

    # inverse maps for flow write-back
    end_node: np.ndarray  # [E]
    end_slot: np.ndarray  # [E] slot of e in end-node's in-list
    start_node: np.ndarray  # [E]
    start_slot: np.ndarray  # [E] slot of e in start-node's out-list

    node_creation_order: List[int] = field(default_factory=list)
    corridors: List[Tuple[int, int]] = field(default_factory=list)
    link_id_to_idx: Dict[Tuple[int, int], int] = field(default_factory=dict)

    @property
    def neighbor_to_slot(self) -> List[Dict[int, int]]:
        """Per node: neighbour id (or -1 for virtual) -> slot index."""
        out = []
        for n in range(self.n_nodes):
            d = {}
            for k in range(self.max_deg):
                nb = int(self.slot_neighbor[n, k])
                if nb != -2:
                    d[nb] = k
            out.append(d)
        return out


def resolve_link_params(params: dict, i: int, j: int) -> dict:
    """Per-corridor parameter resolution (network.py:169-192): the
    default_link dict overlaid with links['i_j'] or links['j_i']."""
    links_config = params.get("links", {}) or {}
    default_params = params.get("default_link", {}) or {}
    fwd, rev = f"{i}_{j}", f"{j}_{i}"
    if fwd in links_config:
        return {**default_params, **links_config[fwd]}
    if rev in links_config:
        return {**default_params, **links_config[rev]}
    return dict(default_params)


def parse_controllers(params: dict):
    """Controller config parsing (network.py:96-107).

    Returns (enabled, controller_nodes set incl. link endpoints,
    controller_gaters set = configured nodes only, controller_links list).
    """
    controller_config = params.get("controllers", {}) or {}
    enabled = controller_config.get("enabled", False)
    nodes = set(map(int, controller_config.get("nodes", set()) or set()))
    gaters = set(nodes)
    links = list(controller_config.get("links", []) or [])
    for link in links:
        a, b = link.split("-")
        nodes.add(int(a))
        nodes.add(int(b))
    return enabled, nodes, gaters, links


def build_topology(
    adjacency_matrix: np.ndarray,
    params: dict,
    origin_nodes: List[int],
    destination_nodes: List[int],
) -> TopologySpec:
    adj = np.asarray(adjacency_matrix)
    n = adj.shape[0]
    origin_set = set(origin_nodes)
    dest_set = set(destination_nodes or [])
    od_set = origin_set | dest_set

    _, _, _, controller_links = parse_controllers(params)
    sep_corridors = set()
    for link in controller_links:
        a, b = map(int, link.split("-"))
        sep_corridors.add((min(a, b), max(a, b)))

    # --- corridors and directed links, reference creation order ---
    # (the i<j row-major scan of network.py:199-213, vectorized: np.nonzero
    # is row-major so the corridor order is identical to the Python loop;
    # the dense double loop was O(n^2) Python-side and dominated build
    # time beyond ~5k nodes)
    ii, jj = np.nonzero(adj == 1)
    upper = jj > ii
    ci, cj = ii[upper], jj[upper]
    corridors = [(int(i), int(j)) for i, j in zip(ci, cj)]
    link_nodes: List[Tuple[int, int]] = []
    for (i, j) in corridors:
        link_nodes.append((i, j))
        link_nodes.append((j, i))
    E = len(link_nodes)
    link_id_to_idx = {uv: e for e, uv in enumerate(link_nodes)}
    reverse_idx = np.array([e ^ 1 for e in range(E)], dtype=np.int32)

    # --- node creation order (first touch in the i<j scan; network.py:199-213):
    # every i enters at its own row; a j>i enters early at its first
    # adjacent i<j row.  first_row[v] = min(v, first i adjacent from above);
    # stable-sorting nodes by (first_row, is_the_row_node_itself, j) gives
    # the exact loop order: at row i, i itself precedes its discovered j's,
    # which appear in ascending j (row-major corridor order).
    first_row = np.arange(n, dtype=np.int64)
    np.minimum.at(first_row, cj, ci)
    # order key: (first_row, 0 for the row node itself, j) — the row node
    # has key j = -1 so it sorts before the j's discovered in that row
    key_j = np.arange(n, dtype=np.int64)
    is_row_self = first_row == np.arange(n)
    key_j = np.where(is_row_self, -1, key_j)
    order = np.lexsort((key_j, first_row))
    created: List[int] = [int(v) for v in order]

    # --- node typing (network.py:141-167) ---
    in_count = adj.sum(axis=0)
    out_count = adj.sum(axis=1)
    has_virtual = np.zeros(n, dtype=bool)
    is_otoo = np.zeros(n, dtype=bool)
    for v in range(n):
        ic, oc = int(in_count[v]), int(out_count[v])
        if ic == 2 and oc == 2:
            if v in od_set:
                has_virtual[v] = True  # RegularNode with virtual pair
            else:
                is_otoo[v] = True
        elif ic == 1 and oc == 1:
            is_otoo[v] = True
            has_virtual[v] = True  # always gets virtual pair (network.py:160-162)
        else:
            if v in od_set:
                has_virtual[v] = True

    # --- incidence: slot 0 = virtual (if any), then neighbours ascending ---
    corridor_nb: List[List[int]] = [[] for _ in range(n)]
    for (i, j) in corridors:
        corridor_nb[i].append(j)
        corridor_nb[j].append(i)
    corridor_nb = [sorted(set(ms)) for ms in corridor_nb]

    arity = np.array(
        [len(corridor_nb[v]) + (1 if has_virtual[v] else 0) for v in range(n)],
        dtype=np.int32,
    )
    M = int(arity.max()) if n else 0

    in_link_idx = -np.ones((n, M), dtype=np.int32)
    out_link_idx = -np.ones((n, M), dtype=np.int32)
    slot_valid = np.zeros((n, M), dtype=bool)
    slot_neighbor = -2 * np.ones((n, M), dtype=np.int32)
    end_node = np.zeros(E, dtype=np.int32)
    end_slot = np.zeros(E, dtype=np.int32)
    start_node = np.zeros(E, dtype=np.int32)
    start_slot = np.zeros(E, dtype=np.int32)
    for v in range(n):
        k = 0
        if has_virtual[v]:
            slot_neighbor[v, 0] = -1
            slot_valid[v, 0] = True
            k = 1
        for m in corridor_nb[v]:
            e_in = link_id_to_idx[(m, v)]
            e_out = link_id_to_idx[(v, m)]
            in_link_idx[v, k] = e_in
            out_link_idx[v, k] = e_out
            slot_neighbor[v, k] = m
            slot_valid[v, k] = True
            # record the slot inverse maps here instead of an np.where
            # scan per directed link afterwards (O(E*M) -> O(E))
            end_node[e_in] = v
            end_slot[e_in] = k
            start_node[e_out] = v
            start_slot[e_out] = k
            k += 1

    # --- per-link params ---
    # fast path when no per-corridor overrides exist (synthetic large
    # grids): every corridor resolves to default_link, so skip the
    # per-corridor dict merges
    uniform = not (params.get("links", {}) or {})
    default_params = params.get("default_link", {}) or {}

    def arr(key, default):
        if uniform:
            return np.full(E, float(default_params.get(key, default)))
        vals = np.zeros(E, dtype=np.float64)
        for c_idx, (i, j) in enumerate(corridors):
            p = resolve_link_params(params, i, j)
            vals[2 * c_idx] = vals[2 * c_idx + 1] = p.get(key, default)
        return vals

    fd_codes = np.zeros(E, dtype=np.int32)
    is_sep = np.zeros(E, dtype=bool)
    if uniform and not sep_corridors:
        fd_codes[:] = FD_TYPES[default_params.get("fd_type", "yperman")]
        link_type = default_params.get("controller_type", "gate")
        if link_type not in ("separator", "gate"):
            raise ValueError(f"Invalid controller type: {link_type}")
        is_sep[:] = link_type == "separator"
    else:
        for c_idx, (i, j) in enumerate(corridors):
            p = resolve_link_params(params, i, j)
            fd_codes[2 * c_idx] = fd_codes[2 * c_idx + 1] = FD_TYPES[p.get("fd_type", "yperman")]
            link_type = "separator" if (i, j) in sep_corridors else p.get("controller_type", "gate")
            if link_type not in ("separator", "gate"):
                raise ValueError(f"Invalid controller type: {link_type}")
            is_sep[2 * c_idx] = is_sep[2 * c_idx + 1] = link_type == "separator"

    link_params = LinkParamArrays(
        length=arr("length", 100.0),
        width=arr("width", 1.0),
        free_flow_speed=arr("free_flow_speed", 1.1),
        k_critical=arr("k_critical", 2.0),
        k_jam=arr("k_jam", 6.0),
        gamma=arr("gamma", 2e-3),
        bi_factor=arr("bi_factor", 1.0),
        activity_probability=arr("activity_probability", 0.0),
        speed_noise_std=arr("speed_noise_std", 0.0),
        fd_type=fd_codes,
        is_separator=is_sep,
    )

    return TopologySpec(
        n_nodes=n,
        n_links=E,
        max_deg=M,
        link_nodes=np.array(link_nodes, dtype=np.int32),
        reverse_idx=reverse_idx,
        link_params=link_params,
        in_link_idx=in_link_idx,
        out_link_idx=out_link_idx,
        slot_valid=slot_valid,
        slot_neighbor=slot_neighbor,
        node_arity=arity,
        has_virtual=has_virtual,
        is_otoo=is_otoo,
        end_node=end_node,
        end_slot=end_slot,
        start_node=start_node,
        start_slot=start_slot,
        node_creation_order=created,
        corridors=corridors,
        link_id_to_idx=link_id_to_idx,
    )
