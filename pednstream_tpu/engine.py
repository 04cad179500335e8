"""The LTM engine: one pure step function, vectorized over links
and nodes, scanned over time.

Semantics re-derived from the reference hot loop (SURVEY.md §3.2):

  Network.network_loading(t)                       src/LTM/network.py:266-287
    per node: turning fractions                    path_finder.py:717-737
    per node: assign_flows(t)                      node.py:164-221
      sending flows   (from state t-1)             link.py:216-370
      receiving flows (uses reverse sending of t)  link.py:372-416
      solve (OneToOne crossing / classic merge)    node.py:230-242, 272-300
      update_links (write cum in/out at t)         node.py:146-162
    update_link_states(t)                          network.py:257-264
      density update                               link.py:133-139
      speed/travel-time/FD update                  link.py:141-188

Key structural fact making this vectorizable: within one step, every
sending flow depends only on state at t-1, and every receiving flow
depends only on the *just-computed sending flow of its reverse link* —
which in a bidirectional network is always an incoming link of the same
node, computed in the same ``assign_flows`` call (node.py:172-206).  So
there is no sequential dependency across the reference's Python node
loop, and the whole step collapses to fixed-shape array ops:

  S[E] -> R[E](S[rev]) -> per-node padded merge/diverge -> scatter-free
  gather write-back -> density/FD state update.

Stochastic terms (binomial release link.py:337-358, activity :350-358,
reverse occupancy thinning :382) run in two modes:
  * ``deterministic``: binomial(n, p) -> floor(n) * p (expectation), the
    mode used for golden-trajectory parity tests;
  * ``stochastic``: jax.random.binomial draws under an explicit PRNG key.
"""

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops.division import div
from .routing import turning_fractions_step
from .state import EngineParams, NetworkState, StepOutputs


def _ring_read(ring: jnp.ndarray, time_idx: jnp.ndarray, H: int) -> jnp.ndarray:
    """Read per-link ring values at (possibly per-link) time indices.

    Rings are time-major [H, E] (see ops/ncurve.py for the layout).  The
    per-link read is expressed as a one-hot masked reduction over the
    window axis, which XLA fuses into one pass over the ring (whether a
    gather reads faster on the GPU is an open ROADMAP item).
    Negative time indices read as 0 for free (the mask of an out-of-range
    index is all zeros).  Adding the zero lanes is IEEE-exact (x + 0.0 ==
    x for the non-negative finite values stored here), so golden parity
    holds.
    """
    if time_idx.ndim == 0:
        return jax.lax.dynamic_index_in_dim(
            ring, jnp.mod(time_idx, H), axis=0, keepdims=False
        )
    idx = jnp.where(time_idx >= 0, jnp.mod(time_idx, H), -1)
    h_ids = jax.lax.broadcasted_iota(jnp.int32, (H,) + idx.shape, 0)
    mask = h_ids == idx[None]
    return jnp.where(mask, ring, 0.0).sum(axis=0)


def _make_rev(scn):
    """Reverse-link permutation ``x -> x[reverse_idx]`` as a lane-shift.

    Topology stores each corridor's two directed links adjacently
    (topology.py: reverse_idx == e ^ 1 by construction), so the reverse
    read is an even/odd lane swap: two shifts and a select that fuse
    into their consumers, bit-identical to the gather (a pure
    permutation).  Falls back to the gather if a custom topology ever
    breaks the pairing.
    """
    rev = np.asarray(scn.reverse_idx)
    E = rev.shape[0]
    if E % 2 == 0 and np.array_equal(rev, np.arange(E, dtype=rev.dtype) ^ 1):
        def _rev(x):
            xl = jnp.concatenate([x[..., 1:], x[..., :1]], axis=-1)
            xr = jnp.concatenate([x[..., -1:], x[..., :-1]], axis=-1)
            even = (jax.lax.broadcasted_iota(
                jnp.int32, x.shape, x.ndim - 1) % 2) == 0
            return jnp.where(even, xl, xr)
        return _rev
    return lambda x: x[..., rev]


def _nofma(scn, x):
    """Block FP contraction (mul+add -> FMA) in exact-parity mode.

    Inside fused kernels LLVM contracts ``a*b + c`` into an FMA wherever
    the target has one (GPUs, and CPUs from AVX2 on), changing the
    last-ulp rounding vs NumPy's two-rounding evaluation.  Because the
    engine floors/rounds flows at integer boundaries, a 1-ulp difference
    flips whole pedestrians.  Routing each product through a select
    (``x`` where ``x == x``, which keeps finite values as they are)
    leaves no multiply feeding the add directly, so nothing contracts.
    An ``optimization_barrier`` does not do this: XLA drops it before
    code generation.  No-op on the fast path."""
    if getattr(scn, "exact_parity", False):
        return jnp.where(x == x, x, jnp.zeros_like(x))
    return x


_FAST_BINOM_EXACT_N = 16


def _binom(key, n, p, stochastic: bool, mode: str = "exact"):
    """Binomial with numpy-style float-n truncation (np.random.binomial
    truncates non-integer n).  Deterministic mode returns the expectation
    floor(n) * p.

    mode='exact' uses jax.random.binomial (transformed rejection — exact
    but the costliest stage of the stochastic step).  mode='fast' is a
    hybrid sampler: exact inverse-CDF sampling for n <= 16 (one uniform
    draw, the binomial pmf walked by its term recursion, instead of 16
    Bernoulli trials' worth of random bits), Gaussian approximation
    with rounding and [0, n] clipping beyond (a standard approximation:
    for n > 16 and the p in [0.5, 0.9] used here the normal
    approximation's total-variation error is small).  Validated
    distributionally in tests/test_stochastic_parity.py.
    """
    nf = jnp.floor(jnp.maximum(n, 0.0))
    if not stochastic:
        return nf * p
    pc = jnp.clip(p, 0.0, 1.0)
    if mode == "exact":
        return jax.random.binomial(key, nf, pc).astype(n.dtype)
    K = _FAST_BINOM_EXACT_N
    k1, k2 = jax.random.split(key)
    f32 = jnp.float32
    u = jax.random.uniform(k1, nf.shape, dtype=f32)
    q = f32(1.0) - pc.astype(f32)
    ratio = div(pc.astype(f32), jnp.maximum(q, f32(1e-12)))
    nf32 = nf.astype(f32)
    pmf = q**nf32  # P[X = 0]
    cdf = pmf
    cnt = jnp.zeros_like(nf32)
    for k in range(K):
        # u >= P[X <= k]  =>  the sample exceeds k
        cnt = cnt + jnp.where((u >= cdf) & (k < nf32), f32(1.0), f32(0.0))
        # times the constant 1/(k+1): a product rounds the same on
        # every backend, and costs less than a corrected quotient
        pmf = pmf * ((nf32 - k) * f32(1.0 / (k + 1.0))) * ratio
        pmf = jnp.where(k + 1.0 <= nf32, pmf, f32(0.0))
        cdf = cdf + pmf
    small = cnt.astype(n.dtype)
    z = jax.random.normal(k2, nf.shape, dtype=jnp.float32).astype(n.dtype)
    mu = nf * pc
    sigma = jnp.sqrt(jnp.maximum(mu * (1.0 - pc), 0.0))
    gauss = jnp.clip(jnp.round(mu + sigma * z), 0.0, nf)
    return jnp.where(nf <= K, small, gauss)


def _sending_flows(scn, ep: EngineParams, st: NetworkState, t, keys, stochastic):
    """Vectorized Link.cal_sending_flow(t-1) over all directed links
    (link.py:216-370).

    Dtype staging mirrors the reference's NumPy promotion: density /
    congestion / release factors and the diffusion coefficient F stay in
    float32 (the dtype of the stored state arrays, link.py:82-97), while
    N-curve and flow arithmetic runs in the flow dtype.
    """
    f = scn.ftype
    f32 = jnp.float32
    rev = _make_rev(scn)
    dt = scn.unit_time
    ts = t - 1

    num_peds32 = st.num_peds  # f32
    area = jnp.where(
        scn.is_separator, ep.length * st.sep_width, ep.length * ep.width
    )
    area32 = area.astype(f32)
    # get_density(ts): shared bidirectional for Link (link.py:190-197),
    # stored own density for Separator (link.py:427-428)
    shared_density32 = jnp.where(
        scn.is_separator, st.density, div(num_peds32 + rev(num_peds32), area32)
    )
    own_density32 = st.density

    avg_tt = st.avg_tt  # float32, value at ts
    tau = jnp.round(div(avg_tt, dt)).astype(jnp.int32)  # link.py:260
    if scn.H < scn.simulation_steps + 1:
        # windowed-history mode: bound the N-curve lookback to the ring
        tau = jnp.minimum(tau, scn.H - 6)

    early = ts < ep.free_flow_tau  # link.py:267-269

    # free-flow / congestion blended N-curve boundary (link.py:274-288)
    diff_fused = None
    if not getattr(scn, "exact_parity", False) and stochastic:
        # fast path: boundary + all 4 diffusion taps from ONE pass over
        # the cum_in ring (inflow[s] = cum_in[s] - cum_in[s-1] — exact
        # for the integer-valued flows of stochastic mode below 2**24;
        # deterministic mode's fractional flows accumulate rounding in
        # cum_in, so it reads the inflow ring directly below instead)
        from .ops import boundary_and_diffusion_reads

        F = div(f32(1.0), f32(1.0) + ep.gamma.astype(f32) * avg_tt)
        one_m_f = f32(1.0) - F
        coefs = jnp.stack(
            [F, F * one_m_f, F * one_m_f**2, F * one_m_f**3], axis=0
        ).astype(st.cum_in_ring.dtype)
        idx = jnp.maximum(0, t - tau)  # = ts + 1 - tau
        cum_in_at, diff_fused = boundary_and_diffusion_reads(
            st.cum_in_ring, idx, ts - tau, coefs, scn.H
        )
    else:
        idx = jnp.maximum(0, t - tau)  # = ts + 1 - tau
        cum_in_at = _ring_read(st.cum_in_ring, idx, scn.H)
    cf32 = jnp.clip(
        div(own_density32 - ep.k_critical.astype(f32),
            (ep.k_jam - ep.k_critical).astype(f32)),
        0.0,
        1.0,
    )
    boundary_freeflow = jnp.maximum(0.0, cum_in_at - st.cum_out)
    boundary = _nofma(scn, (cf32 * num_peds32).astype(f)) + _nofma(
        scn, (f32(1.0) - cf32).astype(f) * boundary_freeflow
    )

    front_gate = rev(st.back_gate)  # link.py:110-126 cross-coupling
    cap = front_gate * ep.k_critical * ep.free_flow_speed * dt  # link.py:296
    sending = jnp.minimum(boundary, cap)
    original = sending

    # stochastic release mitigation (link.py:309-346); factors in f32
    releasing_factor32 = jnp.clip(div(shared_density32, ep.k_jam.astype(f32)), 0.0, 1.0)
    releasing_prob32 = f32(0.7) + _nofma(
        scn, f32(0.15) * releasing_factor32 ** f32(0.8)
    )  # exponent=0.8, link.py:80

    # diffusion outflow, 4 lagged inflows (get_outflow, link.py:199-214);
    # F is f32 (gamma * avg_tt_f32), lag terms accumulate left-to-right in
    # the flow dtype as in the reference expression (link.py:210-212)
    if diff_fused is not None:
        diff_raw = diff_fused
    elif not getattr(scn, "exact_parity", False):
        # deterministic fast path: one weighted pass over the inflow
        # ring (fractional flows — the cum-difference reconstruction
        # above is only ulp-exact for integer flows)
        from .ops import diffusion_single_pass

        F = div(f32(1.0), f32(1.0) + ep.gamma.astype(f32) * avg_tt)
        one_m_f = f32(1.0) - F
        coefs = jnp.stack(
            [F, F * one_m_f, F * one_m_f**2, F * one_m_f**3], axis=0
        ).astype(st.inflow_ring.dtype)
        diff_raw = diffusion_single_pass(st.inflow_ring, ts - tau, coefs, scn.H)
    else:
        # exact-parity: reference summation order (link.py:210-212), 4
        # separate inflow-ring reads
        F = div(f32(1.0), f32(1.0) + _nofma(scn, ep.gamma.astype(f32) * avg_tt))
        base = ts - tau
        one_m_f = f32(1.0) - F
        infl = [_ring_read(st.inflow_ring, base - k, scn.H) for k in range(4)]
        diff_raw = (
            (_nofma(scn, F * infl[0]) + _nofma(scn, (F * one_m_f) * infl[1]))
            + _nofma(scn, (F * one_m_f**2) * infl[2])
        ) + _nofma(scn, (F * one_m_f**3) * infl[3])
    diffusion = jnp.maximum(jnp.ceil(diff_raw), 0.0)

    freeflow = shared_density32 <= ep.k_critical.astype(f32)
    # platoon mix (link.py:329-330).  NB the reference computes the second
    # coefficient as (1 - weight) = 0.19999999999999996, not 0.2 — the
    # 1-ulp difference flips floor() at integer boundaries.
    w_mix = 0.8
    mixed = jnp.floor(
        jnp.minimum(
            _nofma(scn, w_mix * diffusion) + _nofma(scn, (1.0 - w_mix) * sending),
            sending,
        )
    )
    released = _binom(keys[0], sending, releasing_prob32, stochastic,
                      getattr(scn, "binomial_mode", "exact"))  # link.py:336-343
    s_pos = jnp.where(freeflow, jnp.where(diffusion > 0, mixed, released), released)
    sending = jnp.where(sending > 0, s_pos, sending)

    # activity stay (link.py:350-358).  Skipped entirely when
    # activity_probability is a compile-time constant that is zero
    # everywhere (the common case) — the draw would be fully masked out.
    act_p = ep.activity_probability
    act_statically_zero = not isinstance(act_p, jax.core.Tracer) and bool(
        np.all(np.asarray(act_p) <= 0)
    )
    if not act_statically_zero:
        staying = _binom(keys[1], sending, act_p, stochastic,
                         getattr(scn, "binomial_mode", "exact"))
        sending = jnp.where(
            (act_p > 0) & (sending > 1), sending - staying, sending
        )

    # EMA smoothing against previous sending flow (link.py:362-364)
    sending = jnp.maximum(0.0, sending)
    sending = jnp.minimum(
        jnp.floor(_nofma(scn, 0.8 * sending) + _nofma(scn, 0.2 * st.sending_prev)),
        original,
    )

    S = jnp.where(early, 0.0, sending).astype(f)
    return S, shared_density32


def _receiving_flows(scn, ep: EngineParams, st: NetworkState, t, S, key, stochastic,
                     tau_shock_np=None):
    """Vectorized cal_receiving_flow(_with_reverse) (link.py:372-416) and
    the Separator variant (link.py:480-512).

    tau_shock_np: concrete per-link tau_shockwave when it is a
    compile-time constant (step_fn extracts it BEFORE promoting
    EngineParams leaves to jnp — see the staging note there), else None.
    """
    f = scn.ftype
    rev = _make_rev(scn)
    dt = scn.unit_time

    area = jnp.where(
        scn.is_separator, ep.length * st.sep_width, ep.length * ep.width
    )
    num_peds = st.num_peds.astype(f)

    windowed = scn.H < scn.simulation_steps + 1
    tau_np = None
    if not getattr(scn, "exact_parity", False) and tau_shock_np is not None:
        # tau_shockwave is a compile-time constant (the common case —
        # it only becomes traced under per-replica domain
        # randomization).  When it takes few distinct values, replace
        # the full-ring one-hot reduction with one cheap whole-row
        # read per distinct lookback: D*E bytes instead of H*E.  On a
        # uniform-length network (D == 1) this removes a third of the
        # engine's ring bandwidth outright.
        tau_np = tau_shock_np
        if windowed:
            tau_np = np.minimum(tau_np, scn.H - 1)
        uniq = np.unique(tau_np)
    if tau_np is not None and len(uniq) <= max(4, scn.H // 8):
        tau_shock = jnp.asarray(tau_np)
        cum_out_at = jnp.zeros_like(st.cum_out)
        for v in uniq.tolist():
            row = jax.lax.dynamic_index_in_dim(
                st.cum_out_ring,
                jnp.mod(jnp.maximum(t - int(v), 0), scn.H),
                axis=0, keepdims=False,
            )
            cum_out_at = jnp.where(jnp.asarray(tau_np == int(v)), row, cum_out_at)
    else:
        tau_shock = ep.tau_shockwave
        if windowed:
            # the shockwave lookback must stay inside the ring or the
            # read wraps to a value from ~t-(tau mod H) — far too recent
            # — silently inflating receiving flows and weakening jam
            # spillback.  Clamping to H-1 (the oldest retained slot) is
            # part of the windowed-mode approximation, like the avg-tt
            # tau clamp in _sending_flows; tests/test_golden_parity.py
            # quantifies the error.
            tau_shock = jnp.minimum(tau_shock, scn.H - 1)
        cum_out_at = _ring_read(
            st.cum_out_ring, jnp.maximum(t - tau_shock, 0), scn.H
        )
    early = (t - tau_shock) < 0  # ts + 1 - tau_shockwave < 0

    rev_rand = _binom(key, rev(num_peds), 0.9, stochastic,
                      getattr(scn, "binomial_mode", "exact"))  # link.py:382
    kjam_area = ep.k_jam * area

    b_link = jnp.where(
        early,
        kjam_area - rev_rand,
        jnp.maximum(0.0, cum_out_at + kjam_area - rev_rand - st.cum_in),
    )
    b_sep = jnp.where(early, kjam_area, cum_out_at + kjam_area - st.cum_in)
    boundary = jnp.where(scn.is_separator, b_sep, b_link)

    cap = st.back_gate * ep.k_critical * ep.free_flow_speed * dt  # link.py:393
    rf = jnp.minimum(boundary, cap)
    rf = jnp.maximum(rf, 0.0)

    # smoothing against stored receiving flow (link.py:399-401)
    rf = jnp.where(
        st.recv_prev >= 0,
        jnp.minimum(
            jnp.floor(_nofma(scn, rf * 0.8) + _nofma(scn, st.recv_prev * 0.2)), rf
        ),
        rf,
    )

    # reverse-sending subtraction (link.py:407-416); separators skip it
    R = jnp.where(
        scn.is_separator, jnp.maximum(rf, 0.0), jnp.maximum(rf - rev(S), 0.0)
    ).astype(f)
    return R


def _classic_solve(dem_mat, r_pad, exact: bool):
    """'classic' proportional supply allocation (node.py:272-300) over an
    arbitrary leading node axis: dem_mat [K, M, M], r_pad [K, M].

    Exact-parity mode divides every demand by its column sum, as the
    reference does.  The fast path scales each column by one correctly
    rounded reciprocal: M times fewer quotients over the largest array
    of the step, and products round the same on every backend."""
    col_sums = dem_mat.sum(axis=1, keepdims=True)  # [K, 1, M]
    col_sums = jnp.where(col_sums != 0, col_sums, 1e-5)
    if exact:
        supply = r_pad[:, None, :] * div(dem_mat, col_sums)
    else:
        supply = dem_mat * (r_pad[:, None, :] * div(1.0, col_sums))
    g = jnp.floor(jnp.minimum(dem_mat, supply))
    q_in = jnp.maximum(0.0, g.sum(axis=2))  # outflow of incoming slot i
    q_out = jnp.maximum(0.0, g.sum(axis=1))  # inflow to outgoing slot j
    return q_in, q_out


def _node_solve(scn, ep: EngineParams, st: NetworkState, t, S, R, phi, phi_c=None):
    """Padded merge/diverge over all nodes at once.

    Gathers per-node sending/receiving vectors (node.py:164-221 with the
    origin-demand and destination-M special cases), solves OneToOne by the
    crossing rule (node.py:230-242) and Regular by the 'classic'
    proportional supply allocation (node.py:272-300), then gathers flows
    back to the link axis.

    When ``phi_c`` is given (fast routed path), ``phi`` is the static
    ``phi_base`` and ``phi_c`` holds the dynamic turning fractions of the
    NR routed nodes only (routing.RoutingTables.routed_ids); the classic
    solve runs on phi_base everywhere and the routed rows are re-solved
    compactly and written over the result — the solve is row-local per
    node, so this equals the dense computation exactly while never
    materializing a batched [B, N, M, M] phi.
    """
    f = scn.ftype
    N, M = scn.n_nodes, scn.max_deg

    demand_t = ep.demand[:, t - 1].astype(f)  # node.py:176

    in_idx = scn.in_link_idx  # [N, M]
    out_idx = scn.out_link_idx
    in_safe = jnp.maximum(in_idx, 0)
    out_safe = jnp.maximum(out_idx, 0)
    virt_slot = scn.has_virtual[:, None] & (jnp.arange(M)[None, :] == 0)

    s_pad = jnp.where(in_idx >= 0, S[in_safe], 0.0)
    s_pad = jnp.where(virt_slot, demand_t[:, None], s_pad)
    s_pad = jnp.where(scn.slot_valid, s_pad, 0.0)

    r_pad = jnp.where(out_idx >= 0, R[out_safe], 0.0)
    # virtual-slot receiving: big-M for active OD nodes (node.py:187,
    # M = 1e6), 0 for OD candidates deactivated by per-replica
    # randomization (ep.virt_recv)
    r_pad = jnp.where(virt_slot, ep.virt_recv[:, None].astype(f), r_pad)
    r_pad = jnp.where(scn.slot_valid, r_pad, 0.0)

    if scn.assign_flows_type == "optimal":
        # LP allocation via host callback (node.py:248-271); off the hot
        # path — no shipped scenario uses it
        shape = (
            jax.ShapeDtypeStruct((N, M), f),
            jax.ShapeDtypeStruct((N, M), f),
        )

        def _host_lp(s, r, p):
            qi, qo = scn.optimal_solver(np.asarray(s), np.asarray(r), np.asarray(p))
            import numpy as _np

            return qi.astype(_np.dtype(f)), qo.astype(_np.dtype(f))

        q_in_reg, q_out_reg = jax.pure_callback(
            _host_lp, shape, s_pad, r_pad, phi, vmap_method="sequential"
        )
    else:
        # --- classic RegularNode solve (node.py:272-300) ---
        exact = getattr(scn, "exact_parity", False)
        q_in_reg, q_out_reg = _classic_solve(phi * s_pad[:, :, None], r_pad, exact)
        if phi_c is not None:
            # re-solve the routed rows on their compact dynamic phi and
            # overwrite (static sorted unique ids -> cheap batched scatter)
            ids = scn.routing.routed_ids
            q_in_c, q_out_c = _classic_solve(phi_c * s_pad[ids][:, :, None],
                                             r_pad[ids], exact)
            q_in_reg = q_in_reg.at[ids].set(q_in_c)
            q_out_reg = q_out_reg.at[ids].set(q_out_c)

    # --- OneToOne crossing solve (node.py:230-242): slot k <-> slot 1-k ---
    s2 = s_pad[:, :2]
    r2 = r_pad[:, :2]
    q_in_oto = jnp.minimum(s2, r2[:, ::-1])  # q_in[k] = min(s[k], r[1-k])
    q_out_oto = jnp.minimum(s2[:, ::-1], r2)  # q_out[k] = min(s[1-k], r[k])
    pad_zeros = jnp.zeros((N, M - 2), dtype=f) if M > 2 else None
    if M > 2:
        q_in_oto = jnp.concatenate([q_in_oto, pad_zeros], axis=1)
        q_out_oto = jnp.concatenate([q_out_oto, pad_zeros], axis=1)

    otoo = scn.is_otoo[:, None]
    q_in = jnp.where(otoo, q_in_oto, q_in_reg)
    q_out = jnp.where(otoo, q_out_oto, q_out_reg)

    # write-back: each directed link is incoming to exactly one node and
    # outgoing from exactly one node (node.py:146-162)
    outflow_e = q_in[scn.end_node, scn.end_slot]
    inflow_e = q_out[scn.start_node, scn.start_slot]
    virt_dep = jnp.where(scn.has_virtual, q_in[:, 0], 0.0)
    virt_arr = jnp.where(scn.has_virtual, q_out[:, 0], 0.0)
    return inflow_e, outflow_e, virt_dep, virt_arr


def _update_link_states(scn, ep: EngineParams, st: NetworkState, t, inflow_e, outflow_e, key, stochastic):
    """Density + FD speed/travel-time update (network.py:257-264,
    link.py:133-188, Separator variant link.py:430-452)."""
    from .fd import speed_from_density, link_flow_kv

    f = scn.ftype
    f32 = jnp.float32
    rev = _make_rev(scn)
    W = scn.avg_tt_window

    num_peds = (st.num_peds.astype(f) + (inflow_e - outflow_e)).astype(f32)
    area = jnp.where(scn.is_separator, ep.length * st.sep_width, ep.length * ep.width)
    density = div(num_peds, area.astype(f32))  # f32 division (link.py:136)

    # FD speed in f32 staging (update_speeds, link.py:141-188)
    k_self = density
    k_opp = jnp.where(scn.is_separator, f32(0.0), rev(density))
    k_eff = k_self + _nofma(scn, ep.bi_factor.astype(f32) * k_opp)
    v = speed_from_density(k_eff, ep.free_flow_speed, ep.k_critical, ep.k_jam, scn.fd_type)
    if stochastic:
        noise = (
            jax.random.normal(key, v.shape, dtype=f) * ep.speed_noise_std
        )
        v = jnp.where(ep.speed_noise_std > 0, (v.astype(f) + noise).astype(f32), v)
    v = jnp.maximum(f32(0.0), v)

    speed = v
    # In the reference's free-flow branch (yperman/greenshields, k_eff <=
    # k_critical, no noise) the speed is a Python float, so length/speed
    # divides in f64; elsewhere the f32 speed forces an f32 division.
    # ep.tt_freeflow32 carries the f64-then-cast value.
    from .topology import FD_TYPES

    kc32 = ep.k_critical.astype(f32)
    ff_exact = (k_eff <= kc32) & (scn.fd_type != FD_TYPES["smulders"])
    if stochastic:
        ff_exact = ff_exact & (ep.speed_noise_std <= 0)
    tt_f32div = div(ep.length.astype(f32), jnp.where(v > 0, v, f32(1.0)))
    travel_time = jnp.where(
        v > 0,
        jnp.where(ff_exact, ep.tt_freeflow32, tt_f32div),
        ep.max_travel_time,
    )
    link_flow = link_flow_kv(density, speed)

    # rolling average travel time (link.py:84-91,183-186)
    run_sum = st.tt_run_sum + travel_time
    old = _ring_read(st.tt_ring, jnp.maximum(t - W, 0), W)
    run_sum = jnp.where(t >= W, run_sum - old, run_sum)
    avg_tt = jnp.where(t >= W, div(run_sum, W), ep.travel_time0)
    tt_ring = st.tt_ring.at[t % W].set(travel_time)

    return num_peds, density, speed, travel_time, link_flow, avg_tt, run_sum, tt_ring


def step_fn(scn, ep: EngineParams, st: NetworkState, stochastic: bool = False,
            record: bool = True, t_shared=None
            ) -> Tuple[NetworkState, Optional[StepOutputs]]:
    """One full network_loading(t) step as a pure function.

    t_shared: optional scalar time index shared across a lockstep batch.
    When ``step_fn`` is vmapped, ``st.t`` is per-replica, so the ring-row
    writes ``ring.at[t % H].set(x)`` batch into scatters and the
    ``od_table[:, t]`` read into a gather.  Passing the (identical) time
    as an UNBATCHED
    scalar closed over by the vmap turns them back into single
    dynamic-(update-)slices.  Batched lockstep callers do
    ``t0 = states.t[0]`` outside the vmap and pass it here; semantics
    are identical whenever all replicas share the same t (asserted
    nowhere — callers own the lockstep invariant, which holds for every
    batched path in this package: episodes reset together).
    """
    # Static-constant analysis MUST read the caller's leaves before the
    # asarray promotion below: jnp.asarray stages even concrete NumPy
    # constants as tracers while tracing, which would defeat the
    # distinct-tau row-read fast path in _receiving_flows.
    raw_ts = ep.tau_shockwave
    tau_shock_np = None if isinstance(raw_ts, jax.core.Tracer) else np.asarray(raw_ts)
    # EngineParams may carry NumPy leaves (backend-independent scenario
    # constants); promote to jnp so traced indexing works.  No-op for
    # already-traced/device values.
    ep = jax.tree_util.tree_map(jnp.asarray, ep)
    f = scn.ftype
    t = st.t if t_shared is None else t_shared

    key = st.key
    if stochastic:
        key, k_rel, k_act, k_rev, k_noise = jax.random.split(key, 5)
    else:
        k_rel = k_act = k_rev = k_noise = key

    # 1) sending flows from state t-1 (all links simultaneously)
    S, shared_density = _sending_flows(scn, ep, st, t, (k_rel, k_act), stochastic)

    # 2) dynamic turning fractions (path_finder.py:717-737); density and
    #    receiving-capacity reads are t-1 / t-2 state, so order-free.
    phi_c = None
    if scn.routing is not None:
        cap_default = (
            st.back_gate * ep.k_critical * ep.free_flow_speed * scn.unit_time
        ).astype(f)
        od_flow_t = ep.od_table[:, t]
        exact_phi = getattr(scn, "exact_parity", False)
        # fast classic path: keep phi COMPACT over the NR routed nodes and
        # let _node_solve correct just those rows — a batched dense
        # [B, N, M, M] phi is pure memory traffic when NR << N
        # (grid_50x50: 115 of 2,500 nodes)
        use_compact = not exact_phi and scn.assign_flows_type != "optimal"
        phi_or_c = turning_fractions_step(
            scn.routing, scn.n_nodes, scn.max_deg, scn.node_arity, scn.slot_valid,
            shared_density, st.recv_prev.astype(f), cap_default, od_flow_t,
            ep.phi_base, exact=exact_phi, compact=use_compact,
        )
        if use_compact:
            phi, phi_c = ep.phi_base, phi_or_c
        else:
            phi = phi_or_c
    else:
        phi = ep.phi_base

    # 3) receiving flows (needs S of reverse links)
    R = _receiving_flows(scn, ep, st, t, S, k_rev, stochastic,
                         tau_shock_np=tau_shock_np)

    # 4) node merge/diverge + write-back
    inflow_e, outflow_e, virt_dep, virt_arr = _node_solve(scn, ep, st, t, S, R, phi,
                                                          phi_c=phi_c)

    # 5) cumulative curves (node.py:146-162 via link.py:19-25)
    cum_in = st.cum_in + inflow_e
    cum_out = st.cum_out + outflow_e
    cum_in_ring = st.cum_in_ring.at[t % scn.H].set(cum_in)
    cum_out_ring = st.cum_out_ring.at[t % scn.H].set(cum_out)
    # the inflow ring is read in-loop only by the exact-parity and
    # deterministic diffusion paths (the stochastic fast path
    # reconstructs the taps from cum_in differences); elsewhere it is
    # diagnostic state for host-side consumers (rl/optimization_based.py)
    # that scenarios can opt out of maintaining (track_inflow_ring)
    need_inflow_ring = (
        getattr(scn, "track_inflow_ring", True)
        or getattr(scn, "exact_parity", False)
        or not stochastic
    )
    if need_inflow_ring:
        inflow_ring = st.inflow_ring.at[t % scn.H].set(inflow_e)
    else:
        inflow_ring = st.inflow_ring

    # 6) density/speed updates
    num_peds, density, speed, travel_time, link_flow, avg_tt, run_sum, tt_ring = (
        _update_link_states(scn, ep, st, t, inflow_e, outflow_e, k_noise, stochastic)
    )

    new_state = st.replace(
        t=st.t + 1,
        key=key,
        cum_in_ring=cum_in_ring,
        cum_out_ring=cum_out_ring,
        inflow_ring=inflow_ring,
        tt_ring=tt_ring,
        cum_in=cum_in,
        cum_out=cum_out,
        inflow=inflow_e,
        outflow=outflow_e,
        num_peds=num_peds,
        density=density,
        speed=speed,
        travel_time=travel_time,
        link_flow=link_flow,
        avg_tt=avg_tt,
        tt_run_sum=run_sum,
        sending_prev=S,
        recv_prev=R,
        virt_dep=virt_dep,
        virt_arr=virt_arr,
        virt_dep_cum=st.virt_dep_cum + virt_dep,
        virt_arr_cum=st.virt_arr_cum + virt_arr,
    )

    out = None
    if record:
        out = StepOutputs(
            inflow=inflow_e, outflow=outflow_e, cum_in=cum_in, cum_out=cum_out,
            num_peds=num_peds, density=density, speed=speed,
            travel_time=travel_time, link_flow=link_flow, sending=S,
            receiving=R, back_gate=st.back_gate, sep_width=st.sep_width,
            virt_dep=virt_dep, virt_arr=virt_arr,
        )
    return new_state, out


def make_step(scn, stochastic: bool = False, record: bool = False,
              donate: bool = False):
    """Jitted single-step function ``(params, state) -> (state, outputs)``.

    ``donate=True`` donates the input state's buffers to the output
    (in-place ring updates, no copies) — use when the previous state is
    never touched again, e.g. the interactive/MCP stepping loop."""

    @partial(jax.jit, donate_argnums=(1,) if donate else ())
    def _step(ep: EngineParams, st: NetworkState):
        return step_fn(scn, ep, st, stochastic=stochastic, record=record)

    return _step


def simulate_batched(scn, ep: EngineParams, states: NetworkState,
                     num_steps: int, stochastic: bool = False,
                     ep_batched: bool = False) -> NetworkState:
    """Lockstep rollout over a batch of replicas: scan OUTSIDE, vmap
    inside, with the shared per-step time closed over each vmap as an
    unbatched scalar (see ``step_fn`` ``t_shared``) — ring-row writes
    compile to dynamic-update-slices instead of per-replica scatters.

    ``states`` carries a leading batch axis on every leaf; all replicas
    must share the same ``t`` (they do for every batched path in this
    package).  ``ep_batched=True`` for per-replica EngineParams (domain
    randomization).  Returns the final batched state.
    """
    t0 = states.t[0]
    ts = t0 + jnp.arange(num_steps, dtype=jnp.int32)

    def body(ss, tcur):
        if ep_batched:
            ss = jax.vmap(
                lambda s, e: step_fn(scn, e, s, stochastic=stochastic,
                                     record=False, t_shared=tcur)[0]
            )(ss, ep)
        else:
            ss = jax.vmap(
                lambda s: step_fn(scn, ep, s, stochastic=stochastic,
                                  record=False, t_shared=tcur)[0]
            )(ss)
        return ss, None

    return jax.lax.scan(body, states, ts)[0]


def simulate(scn, ep: EngineParams, state: NetworkState, num_steps: int,
             stochastic: bool = False, record: bool = True):
    """Run ``num_steps`` loading steps with lax.scan.

    Equivalent to the reference driver loop
    ``for t in range(1, simulation_steps): network.network_loading(t)``
    (examples/long_corridor.py:126-127), fused into one XLA program.
    """

    def body(st, _):
        return step_fn(scn, ep, st, stochastic=stochastic, record=record)

    final, outs = jax.lax.scan(body, state, None, length=num_steps)
    return final, outs
