"""N-curve history reads.

The engine's only non-elementwise work is reading per-link history
values at per-link dynamic time offsets (cumulative-curve lookbacks,
link.py:260-288,380; diffusion lags, link.py:199-214).  Each read is a
one-hot masked reduction over the ring's window axis, which XLA fuses
into one pass over the ring; these forms cut the number of passes:

- :func:`diffusion_single_pass` folds the 4 lagged-inflow reads into ONE
  masked-coefficient reduction over the ring (4x less inflow-ring
  traffic).  Used on the deterministic fast path (exact-parity mode
  keeps the reference's 4-read summation order).
- :func:`boundary_and_diffusion_reads` reads the N-curve boundary and all
  four diffusion taps from one pass over the cumulative-inflow ring
  (stochastic fast path).

Rings are stored time-major [H, E]: the per-step row write
``ring[t % H] = x`` touches one contiguous row, and the reductions run
over the short window axis for every link in parallel.
"""

import jax
import jax.numpy as jnp


def diffusion_single_pass(inflow_ring, base, coefs, H: int):
    """diff_raw[e] = sum_k coefs[k,e] * inflow_ring[(base[e]-k) % H, e]
    for k in 0..3 with base[e]-k >= 0, computed in one pass.

    inflow_ring: [H, E] time-major; base: [E] int; coefs: [4, E].
    """
    h_ids = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)
    base_slot = jnp.mod(base, H)[None, :]
    k = jnp.mod(base_slot - h_ids, H)  # lag index of slot h: [H, E]
    valid = (k < 4) & ((base[None, :] - k) >= 0)
    # per-slot coefficient by select over the 4 lags
    coef = jnp.where(
        k == 0, coefs[0][None, :],
        jnp.where(k == 1, coefs[1][None, :],
                  jnp.where(k == 2, coefs[2][None, :], coefs[3][None, :])),
    )
    coef = jnp.where(valid, coef, 0.0)
    return (inflow_ring * coef).sum(axis=0)


def boundary_and_diffusion_reads(cum_in_ring, idx_ci, base, coefs, H: int):
    """The free-flow N-curve boundary AND the 4-lag diffusion term from
    ONE pass over the cumulative-inflow ring.

    The diffusion taps (get_outflow, link.py:199-214) are lagged
    *inflows*; ``inflow[s] == cum_in[s] - cum_in[s-1]`` — an equality
    that is exact when flows are integer-valued (stochastic mode) and
    cum_in stays below 2**24; in deterministic mode flows are fractional
    and the reconstructed taps can drift an ulp from the stored inflow
    ring as cum_in grows (the exact-parity path in engine.py therefore
    reads the inflow ring directly and never calls this).  The five
    consecutive cum_in values at slots ``base-4 .. base`` recover all
    four taps, so the inflow ring never has to be read, halving the
    sending-flow HBM traffic.

    The telescoped sum ``sum_k coefs[k] * (v_k - v_{k+1})`` collapses to
    ONE weighted reduction with per-slot weights

        w_0 = c_0,  w_k = c_k - c_{k-1} (k=1..3),  w_4 = -c_3,

    where slot-validity (``base - j >= 0``, gating the WHOLE telescoped
    weight — the value at an out-of-range slot is a wrapped ring row and
    must contribute nothing) is folded into the weights on the [E] axis,
    so the per-[H, E]-element cost is one lag compute + a 5-way weight
    select + multiply-add.  Both outputs share the one lag index; a
    negative ``idx_ci`` reads 0 via an [E]-level sentinel slot, costing
    nothing per ring element.  XLA multi-output-fuses the two
    accumulators into a single read of the ring.

    cum_in_ring: [H, E] time-major; idx_ci, base: [E] int; coefs: [4, E].
    Returns (cum_in_at[E], diff_raw[E]).
    """
    h_ids = jax.lax.broadcasted_iota(jnp.int32, (H, 1), 0)

    # sentinel H never matches a row, so negative indices read as 0
    idx_eff = jnp.where(idx_ci >= 0, jnp.mod(idx_ci, H), H)
    sel_ci = h_ids == idx_eff[None, :]
    base_slot = jnp.mod(base, H)[None, :]
    k = jnp.mod(base_slot - h_ids, H)  # slot h holds time base-k

    # telescoped weights u_j, validity (base - j >= 0) gating each whole
    # weight: diff = sum_j [base>=j] * u_j * ring[(base-j) % H]
    u = [coefs[0], coefs[1] - coefs[0], coefs[2] - coefs[1],
         coefs[3] - coefs[2], -coefs[3]]
    w = [jnp.where(base >= j, u[j], 0.0) for j in range(5)]

    coef = jnp.where(
        k == 0, w[0][None, :],
        jnp.where(k == 1, w[1][None, :],
                  jnp.where(k == 2, w[2][None, :],
                            jnp.where(k == 3, w[3][None, :],
                                      jnp.where(k == 4, w[4][None, :], 0.0)))),
    )
    # BOTH accumulators through ONE variadic lax.reduce: two sibling
    # jnp.sum calls can compile to two reduce fusions that each stream
    # the full [H, E] ring from memory; a single variadic reduce makes
    # XLA emit one fusion that loads each ring element once and feeds
    # both multiply-accumulates.  Mask-multiply is IEEE-exact here: ring
    # values are finite and non-negative, so 1.0*x == x and 0.0*x == 0.
    zero = jnp.zeros((), cum_in_ring.dtype)
    ci, diff = jax.lax.reduce(
        (cum_in_ring * sel_ci.astype(cum_in_ring.dtype), cum_in_ring * coef),
        (zero, zero),
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        [0],
    )
    return ci, diff
