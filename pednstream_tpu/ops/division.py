"""Correctly rounded float32 division on every backend.

The engine reproduces the reference's NumPy float32 arithmetic and then
floors or rounds flows and lookbacks at integer boundaries, so a quotient
one ulp off flips whole pedestrians.  XLA's GPU backend divides float32
with an approximate instruction (up to 2 ulp off) where NumPy and XLA's
CPU backend round correctly.  ``div`` takes that quotient and corrects it
with an exact integer remainder, so it returns the IEEE quotient on any
backend; other dtypes divide as ``/`` does.

The correction, for normal operands and a normal result: with the
significands ``ma``, ``mb`` (24-bit integers) the exact quotient's
significand is ``X = ma * 2**s / mb`` in ``[2**23, 2**24)``.  The
approximate quotient, scaled by a power of two, gives an integer ``S0``
within a few units of ``X``; the remainder ``R = ma * 2**s - S0 * mb`` is
small, so it is exact in 32-bit arithmetic taken modulo 2**32, and
``S0 + round(R / mb)`` is the correctly rounded significand (an exact
quotient never lies halfway between two float32 values).  Zeros,
infinities, NaNs, subnormals and results near the ends of the exponent
range keep the backend's quotient.
"""

import jax
import jax.numpy as jnp

# farthest the backend's quotient may be from the exact one, in units of
# the result's last place (2 on the GPU, 0 on the CPU; the margin covers a
# quotient that rounded into a neighbouring binade)
MAX_UNITS_OFF = 5


def div(a, b):
    """``a / b`` with NumPy's promotion; float32 quotients correctly
    rounded."""
    q = jnp.true_divide(a, b)
    if q.dtype != jnp.float32:
        return q
    a = jnp.broadcast_to(jnp.asarray(a).astype(jnp.float32), q.shape)
    b = jnp.broadcast_to(jnp.asarray(b).astype(jnp.float32), q.shape)
    return round_quotient(a, b, q)


def round_quotient(a, b, q):
    """The correctly rounded float32 ``a / b`` from ``q``, any float32
    within MAX_UNITS_OFF units of it (see the module docstring)."""
    u32, i32 = jnp.uint32, jnp.int32
    bits = lambda x: jax.lax.bitcast_convert_type(x, u32)
    ia, ib = bits(a), bits(b)
    sign = (ia ^ ib) & u32(0x80000000)
    ia, ib = ia & u32(0x7FFFFFFF), ib & u32(0x7FFFFFFF)
    ea, eb = (ia >> 23).astype(i32), (ib >> 23).astype(i32)
    ma = (ia & u32(0x7FFFFF)) | u32(0x800000)
    mb = (ib & u32(0x7FFFFF)) | u32(0x800000)
    lo = (ma < mb).astype(i32)  # significand quotient below 1
    e = ea - eb + 127 - lo  # biased exponent of the result
    valid = ((ea >= 1) & (ea <= 254) & (eb >= 1) & (eb <= 254)
             & (e >= 23) & (e <= 253))
    e = jnp.where(valid, e, 127)

    # S0 = |q| * 2**(150 - e): the result's significand as an integer
    scale = jax.lax.bitcast_convert_type(((277 - e) << 23).astype(u32), jnp.float32)
    s0 = jnp.round(jnp.abs(q) * scale).astype(i32)
    # R = ma * 2**(23 + lo) - S0 * mb, exact modulo 2**32 since |R| < 2**31
    r = (ma << (23 + lo).astype(u32)) - s0.astype(u32) * mb
    r2 = jax.lax.bitcast_convert_type(r, i32) * 2
    mbi = mb.astype(i32)
    k = jnp.zeros_like(r2)
    for j in range(1, MAX_UNITS_OFF + 1):
        k = k + (r2 > (2 * j - 1) * mbi).astype(i32) - (r2 < -(2 * j - 1) * mbi).astype(i32)
    # a significand of 2**24 carries into the exponent field
    out = ((e << 23) + (s0 + k - (1 << 23))).astype(u32) | sign
    return jnp.where(valid, jax.lax.bitcast_convert_type(out, jnp.float32), q)
