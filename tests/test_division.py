"""Correctly rounded float32 division (ops/division.py).

NumPy and XLA's CPU backend divide float32 with IEEE rounding; XLA's GPU
backend does not (up to 2 ulp off).  These tests check ``div`` against
NumPy, check that its correction recovers the IEEE quotient from one a
few ulp off, and rerun the engine with the CPU's float32 divide lowered
one ulp off: every divide the engine does must still come out exact.
"""

import contextlib
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax._src.interpreters import mlir
from jax._src.lib.mlir.dialects import hlo

from pednstream_tpu.ops.division import div, round_quotient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _operands(kind, n=1 << 16, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "wide":
        a = rng.standard_normal(n) * np.exp2(rng.integers(-50, 50, n))
        b = rng.standard_normal(n) * np.exp2(rng.integers(-50, 50, n))
    else:
        b = rng.uniform(1, 2, n) * np.exp2(rng.integers(-20, 20, n))
        b = b.astype(np.float32)
        a = {"exact": b * np.float32(3),
             "just_below": np.nextafter(b, np.float32(0)),
             "just_above": np.nextafter(b, np.float32(np.inf))}[kind]
    return a.astype(np.float32), b.astype(np.float32)


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("kind", ["wide", "exact", "just_below", "just_above"])
def test_div_matches_numpy(kind):
    a, b = _operands(kind)
    want = a / b
    got = np.asarray(jax.jit(div)(a, b))
    normal = np.abs(want) >= np.finfo(np.float32).tiny  # XLA flushes subnormals
    assert np.array_equal(_bits(got)[normal], _bits(want)[normal])


def test_div_special_values_and_promotion():
    a = np.array([0.0, -0.0, 1.0, np.inf, np.nan, 3.0, -6.0], np.float32)
    b = np.array([2.0, 5.0, 0.0, 2.0, 1.0, np.inf, 3.0], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = a / b
    got = np.asarray(div(a, b))
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    # Python scalars stay weak; integer and float64 operands divide as `/`
    assert div(jnp.float32(1.0), 3).dtype == jnp.float32
    assert div(jnp.arange(3), 2).dtype == jnp.true_divide(jnp.arange(3), 2).dtype
    np.testing.assert_array_equal(np.asarray(div(np.float32(1.0), np.arange(1, 4, dtype=np.float32))),
                                  np.float32(1.0) / np.arange(1, 4, dtype=np.float32))


@pytest.mark.parametrize("units_off", [-3, -2, -1, 1, 2, 3])
def test_round_quotient_corrects_an_inexact_quotient(units_off):
    for kind in ("wide", "exact", "just_below", "just_above"):
        a, b = _operands(kind, seed=1)
        want = a / b
        q = want
        for _ in range(abs(units_off)):
            q = np.nextafter(q, np.float32(np.inf if units_off > 0 else -np.inf))
        got = np.asarray(jax.jit(round_quotient)(a, b, q))
        # the correction covers results of normal magnitude away from the
        # ends of the exponent range; elsewhere it keeps the quotient given
        mag = np.abs(want)
        covered = (mag > 2.0 ** -100) & (mag < 2.0 ** 125)
        assert np.array_equal(_bits(got)[covered], _bits(want)[covered]), kind


def _perturb(q):
    bits = jax.lax.bitcast_convert_type(q, jnp.int32)
    mag = bits & 0x7FFFFFFF
    normal = (mag >= 0x00800000) & (mag < 0x7F000000)
    return jax.lax.bitcast_convert_type(jnp.where(normal, bits + 1, bits), jnp.float32)


def _one_ulp_off_divide(ctx, x, y):
    (aval,) = ctx.avals_out
    x, y = mlir.multi_broadcast_in_dim(ctx, (x, y), ctx.avals_in, aval.shape,
                                       aval.sharding)
    q = hlo.divide(x, y)
    if aval.dtype != np.float32:
        return [q]
    return mlir.lower_fun(_perturb, multiple_results=False)(
        ctx.replace(avals_in=[aval]), q)


@contextlib.contextmanager
def approximate_f32_divide():
    """Lower float32 division on the CPU one ulp off (away from zero),
    as an approximate GPU divide may round it."""
    table = mlir._platform_specific_lowerings["cpu"]
    saved = table.get(jax.lax.div_p)
    jax.clear_caches()
    mlir.register_lowering(jax.lax.div_p, _one_ulp_off_divide, platform="cpu")
    try:
        yield
    finally:
        if saved is None:
            del table[jax.lax.div_p]
        else:
            table[jax.lax.div_p] = saved
        jax.clear_caches()


def test_approximate_divide_is_in_effect():
    one_third = np.float32(1.0) / np.float32(3.0)
    with approximate_f32_divide():
        off = float(jax.jit(jnp.divide)(jnp.float32(1.0), jnp.float32(3.0)))
        fixed = float(jax.jit(div)(jnp.float32(1.0), jnp.float32(3.0)))
    assert off == np.nextafter(one_third, np.float32(1.0))
    assert fixed == one_third


@pytest.mark.parametrize("name", ["long_corridor", "butterfly", "separator_corridor",
                                  "metered_corridor"])
def test_golden_parity_with_an_approximate_divide(name, x64):
    """These fixtures miss the reference with a plain divide that is one
    ulp off (the travel-time and lookback roundings flip)."""
    from pednstream_tpu.golden import scenario_fixture_errors

    with approximate_f32_divide():
        errs = scenario_fixture_errors(name)
    assert max(errs.values()) == 0.0, errs


def test_fast_path_with_an_approximate_divide():
    """The float32 stochastic rollout is bitwise the same whether the
    backend's divide is exact or not."""
    import bench

    def run():
        scn = bench.dataset_scenario("melbourne")
        states = bench.batched_states(scn, 0, 2)
        return jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.asarray, bench.batched_rollout(scn, 40)(states)))

    with jax.enable_x64(False):
        exact = run()
        with approximate_f32_divide():
            off = run()
    for x, y in zip(exact, off):
        np.testing.assert_array_equal(x, y)
