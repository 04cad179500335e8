"""Vectorized fundamental diagrams.

JAX re-expression of the reference FD classes (src/utils/functions.py:3-134):
all three model types evaluated branch-free over the whole link axis with
per-link integer fd codes, so the speed update is one fused VPU pass over
[E].

Dtype staging note: the reference computes FD speeds from float32 density
arrays with Python-float (weak-typed) parameters, so NumPy keeps every
subexpression in float32 (e.g. ``k_jam / k_eff`` casts k_jam to f32).
We reproduce that staging exactly — parameters are cast to float32 at the
same points — so golden-trajectory tests match the reference bit-for-bit
even where a 1-ulp speed difference would later flip an integer flow.

Bidirectional coupling (functions.py:103-134): effective density
``k_eff = k_self + bi_factor * k_opp``; separators use k_opp = 0
(link.py:430-441).
"""

import jax.numpy as jnp

from .ops.division import div
from .topology import FD_TYPES

_f32 = jnp.float32


def speed_from_density(k_eff32, v_f, k_critical, k_jam, fd_type):
    """Speed for effective density (float32), vectorized over links.

    k_eff32: float32 effective density.  v_f/k_critical/k_jam: parameter
    arrays in the flow dtype (cast to f32 at reference promotion points).
    fd_type: int array of FD_TYPES codes.  Returns float32 speeds.
    Greenshields / Yperman-triangular / Smulders per functions.py:112-128.
    """
    vf32 = v_f.astype(_f32)
    kc32 = k_critical.astype(_f32)
    kj32 = k_jam.astype(_f32)
    below = k_eff32 <= kc32
    safe_k = jnp.where(k_eff32 > 0, k_eff32, _f32(1.0))

    # greenshields: -v_f * (k_eff - k_jam) / (k_jam - k_critical)
    den32 = (k_jam - k_critical).astype(_f32)
    v_green = jnp.where(
        below, vf32, jnp.maximum(_f32(0.0), div(-vf32 * (k_eff32 - kj32), den32))
    )
    # yperman: coefficient computed in f64 (python-float math) then cast
    coef32 = div(k_critical * v_f, k_jam - k_critical).astype(_f32)
    v_yper = jnp.where(
        below,
        vf32,
        jnp.maximum(_f32(0.0), coef32 * (div(kj32, safe_k) - _f32(1.0))),
    )
    # smulders: u0 = v_f, gamma = u0 * k_critical (functions.py:107-108)
    gamma32 = (v_f * k_critical).astype(_f32)
    inv_kjam32 = div(1.0, k_jam).astype(_f32)
    v_smul = jnp.where(
        below,
        vf32 * (_f32(1.0) - div(k_eff32, kj32)),
        jnp.maximum(_f32(0.0), gamma32 * (div(_f32(1.0), safe_k) - inv_kjam32)),
    )

    v = jnp.where(
        fd_type == FD_TYPES["greenshields"],
        v_green,
        jnp.where(fd_type == FD_TYPES["yperman"], v_yper, v_smul),
    )
    return v.astype(_f32)


def link_flow_kv(density, speed):
    """q = k * v (functions.py:97-101)."""
    return density * speed
