"""On-device domain randomization for batched training.

The reference randomizes per episode on the host (env_loader.py:160-424:
link capacity/speed incidents on ~20% of corridors, randomized demand
levels, randomized OD flow weights).  For batched training those
perturbations must ride in a vmappable pytree: this module draws a
randomized :class:`EngineParams` per replica with the same perturbation
distributions (demand randomization perturbs levels rather than
re-drawing Poisson curves).  OD-node-set randomization — a topology
edit in the reference — rides in-vmap too when the scenario was built
with ``od_candidates`` (superset topology whose candidate OD nodes are
opened/closed per replica through demand rows, od_table weights, and
the virtual-slot receiving capacity ``EngineParams.virt_recv``); see
``NetworkEnvGenerator.build_od_randomizable``.
"""

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .state import EngineParams


def randomize_engine_params(scn, key: jax.Array) -> EngineParams:
    """One randomized EngineParams draw (same distributions as
    env_loader.py:363-424 for link incidents, :183-259 for demand/OD
    levels; OD-node activation mirroring the k-hop edit moves of
    env_loader.py:261-359 when the scenario was built with
    ``od_candidates``)."""
    ep = jax.tree_util.tree_map(jnp.asarray, scn.engine_params)
    E = scn.n_links
    nc = E // 2
    (k_sel, k_cap, k_capf, k_spd, k_spdf, k_dem, k_od,
     k_oact, k_dact) = jax.random.split(key, 9)

    # ~20% of corridors get an incident (both directions identically)
    corridor_hit = jax.random.uniform(k_sel, (nc,)) < 0.2
    hit = jnp.repeat(corridor_hit, 2)

    # capacity change with p=0.5: factor U(0.6, 1.2) on k_critical/k_jam
    cap_on = jnp.repeat(jax.random.uniform(k_cap, (nc,)) < 0.5, 2) & hit
    cap_f = jnp.repeat(jax.random.uniform(k_capf, (nc,), minval=0.6, maxval=1.2), 2)
    k_crit = jnp.where(cap_on, jnp.maximum(0.5, ep.k_critical * cap_f), ep.k_critical)
    k_jam = jnp.where(cap_on, jnp.maximum(k_crit * 2.0, ep.k_jam * cap_f), ep.k_jam)

    # speed reduction with p=0.5: factor U(0.6, 0.9)
    spd_on = jnp.repeat(jax.random.uniform(k_spd, (nc,)) < 0.5, 2) & hit
    spd_f = jnp.repeat(jax.random.uniform(k_spdf, (nc,), minval=0.6, maxval=0.9), 2)
    ffs = jnp.where(spd_on, ep.free_flow_speed * spd_f, ep.free_flow_speed)

    # demand randomization: the reference REPLACES each origin's demand
    # with fresh light-level curves — base_lambda ~ U(2, 10), peak_lambda
    # ~ U(10, 30) (env_loader.py:185-218) — independent of the scenario's
    # nominal levels (butterfly's nominal sudden-demand peaks at 90).  The
    # in-vmap analog rescales each origin's precomputed curve so its mean
    # rate lands in the same U(2, 10)..U(10, 30) band, preserving the
    # temporal shape.  (Scaling by the nominal level instead — an earlier
    # version — made randomized worlds far MORE jammed than the
    # reference's, drowning the RL signal.)
    # OD-node activation (in-vmap analog of the reference's k-hop OD
    # edits, env_loader.py:261-359: p=0.5 add one two-hop neighbour,
    # p=0.5 drop one, p=0.5 swap — approximated here as independent
    # activations: nominal nodes stay active w.p. 0.75 (≈ per-node
    # survival under the remove move), candidates open w.p.
    # 0.5/n_candidates so the EXPECTED number of opened candidates is
    # 0.5 per side regardless of pool size, matching the ADD move's
    # at-most-one-w.p.-0.5.  The resulting origin-set-size marginal is
    # quantified against the reference's edit-move distribution in
    # tests/test_randomize_od.py and docs/PARITY.md.  A replica whose
    # draw empties a side falls back to the nominal set, mirroring the
    # reference's "keep at least one" guards.
    if getattr(scn, "od_randomizable", False):
        nom_o = jnp.asarray(scn.nominal_origin_mask)
        nom_d = jnp.asarray(scn.nominal_dest_mask)
        cand_o = jnp.asarray(scn.candidate_origin_mask)
        cand_d = jnp.asarray(scn.candidate_dest_mask)
        p_cand_o = 0.5 / max(int(np.sum(scn.candidate_origin_mask)), 1)
        p_cand_d = 0.5 / max(int(np.sum(scn.candidate_dest_mask)), 1)
        u_o = jax.random.uniform(k_oact, (scn.n_nodes,))
        u_d = jax.random.uniform(k_dact, (scn.n_nodes,))
        o_act = (nom_o & (u_o < 0.75)) | (cand_o & (u_o < p_cand_o))
        d_act = (nom_d & (u_d < 0.75)) | (cand_d & (u_d < p_cand_d))
        o_act = jnp.where(o_act.any(), o_act, nom_o)
        d_act = jnp.where(d_act.any(), d_act, nom_d)
        base_demand = jnp.asarray(scn.demand_full) * o_act[:, None]
        pair_act = (o_act[jnp.asarray(scn.od_pair_origin)]
                    & d_act[jnp.asarray(scn.od_pair_dest)])
        virt_recv = jnp.where(
            jnp.asarray(scn.has_virtual) & (o_act | d_act), 1e6, 0.0
        ).astype(ep.virt_recv.dtype)
    else:
        base_demand = ep.demand
        pair_act = None
        virt_recv = ep.virt_recv

    T = ep.demand.shape[1]
    nom_mean = base_demand.sum(axis=1) / T  # per-node mean rate
    target_mean = jax.random.uniform(k_dem, (scn.n_nodes,), minval=4.0,
                                     maxval=18.0)  # mid base..peak band
    dem_scale = jnp.where(nom_mean > 0, target_mean / jnp.maximum(nom_mean, 1e-6), 1.0)
    demand = base_demand * dem_scale[:, None]

    # OD flow weights: U(1, 10) per pair (env_loader.py:224-259); pairs
    # touching a deactivated OD node carry zero weight so the dynamic
    # turning fractions route no flow toward closed destinations
    if ep.od_table.shape[0] > 0:
        w = jax.random.uniform(k_od, (ep.od_table.shape[0],), minval=1.0, maxval=10.0)
        if pair_act is not None:
            w = w * pair_act
        od_table = jnp.broadcast_to(w[:, None], ep.od_table.shape)
    else:
        od_table = ep.od_table

    # derived constants must track the perturbed physics: a replica with a
    # 0.6x speed incident gets the slower free-flow travel time and the
    # longer shockwave lookback, keeping speed/travel_time/reward mutually
    # consistent within the replica (scenario.derive_link_constants)
    from .scenario import derive_link_constants

    derived = derive_link_constants(
        ep.length, ffs, k_crit, k_jam, scn.unit_time, xp=jnp
    )
    return ep.replace(
        k_critical=k_crit.astype(ep.k_critical.dtype),
        k_jam=k_jam.astype(ep.k_jam.dtype),
        free_flow_speed=ffs.astype(ep.free_flow_speed.dtype),
        demand=demand.astype(ep.demand.dtype),
        od_table=od_table.astype(ep.od_table.dtype),
        virt_recv=virt_recv,
        **derived,
    )


def randomize_engine_params_batched(scn, key: jax.Array, batch: int) -> EngineParams:
    """B independent randomized EngineParams (leading batch axis)."""
    return jax.vmap(lambda k: randomize_engine_params(scn, k))(
        jax.random.split(key, batch)
    )
