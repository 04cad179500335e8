"""Link-axis (simulation-state) sharding tests — SURVEY §2.6's TP analog
on the 8-device virtual CPU mesh.

The DP tests (test_parallel.py) shard the replica axis; these shard the
LINK axis of a single replica (parallel/link_shard.py): ring buffers and
N-curve state live blockwise across devices, the node exchange rides
GSPMD-inserted collectives.  Core claims pinned here:

  * bitwise equality with the single-device engine (no reduction order
    changes — deterministic AND stochastic modes);
  * the physical layout really is sharded (addressable shard shapes);
  * no collective materializes a full ring (the memory claim — GSPMD
    falling back to replication would still be numerically right);
  * it works at the blueprint's motivating scale: a synthetic
    ~100k-directed-link grid.
"""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from pednstream_tpu.engine import simulate
from pednstream_tpu.parallel import (
    make_link_sharded_simulate,
    make_mesh,
    shard_link_state,
)
from pednstream_tpu.parallel.link_shard import assert_no_full_ring_collectives
from pednstream_tpu.scenario import build_scenario


def _tiny_controller_scenario(**kw):
    adj = np.array([
        [0, 0, 1, 0, 0],
        [0, 0, 1, 0, 0],
        [1, 1, 0, 1, 1],
        [0, 0, 1, 0, 0],
        [0, 0, 1, 0, 0],
    ])
    params = {
        "simulation_steps": 40,
        "unit_time": 10,
        "seed": 0,
        "default_link": {
            "length": 50, "width": 4, "free_flow_speed": 1.1,
            "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
        },
        "controllers": {"enabled": True, "nodes": [2]},
        "demand": {"origin_0": {"pattern": "constant", "base_lambda": 5}},
    }
    return build_scenario(adj, params, [0, 1], [3, 4], **kw)


def _assert_states_bitequal(ref, out):
    for name in ref.__dataclass_fields__:
        a = getattr(ref, name)
        b = getattr(out, name)
        if name == "key":
            a = jax.random.key_data(a)
            b = jax.random.key_data(b)
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"leaf {name} diverged"
        )


@pytest.mark.parametrize("stochastic", [False, True])
def test_link_sharded_bitexact_tiny(stochastic):
    """E=8 directed links over 8 devices: one link per shard, so every
    reverse pair straddles a shard boundary — the halo path is exercised
    on every single lane.  Sharded must equal unsharded BITWISE."""
    scn = _tiny_controller_scenario()
    ep = scn.engine_params
    st = scn.init_state(jax.random.PRNGKey(0))
    steps = 30

    # ep must be an ARGUMENT here, exactly as the sharded run takes it:
    # closed-over params become embedded constants, and XLA rewrites
    # divide-by-constant into multiply-by-reciprocal (x/200 -> x*0.005,
    # 1 ulp off), which would spuriously diverge from the sharded
    # program's true runtime divide.
    ref = jax.jit(
        lambda e, s: simulate(scn, e, s, steps, stochastic=stochastic,
                              record=False)[0]
    )(ep, st)

    mesh = make_mesh(8, axis="link")
    run = make_link_sharded_simulate(scn, mesh, steps, stochastic=stochastic)
    out = run(ep, shard_link_state(st, mesh))

    # the state stayed link-sharded end to end
    assert out.cum_in_ring.sharding.spec == P(None, "link")
    assert len(out.density.sharding.device_set) == 8
    _assert_states_bitequal(ref, out)


@pytest.mark.parametrize("path", ["state", "simulate", "hybrid"])
def test_link_sharding_rejects_indivisible_link_count(path):
    """E = 8 directed links do not divide over a 3-device link axis: every
    entry point says so instead of failing inside XLA."""
    from pednstream_tpu.parallel import (make_hybrid_sharded_simulate,
                                         make_mesh_2d, shard_hybrid_state)

    scn = _tiny_controller_scenario()
    assert scn.n_links == 8
    with pytest.raises(ValueError, match="do not divide over the 3-device"):
        if path == "state":
            shard_link_state(scn.init_state(jax.random.PRNGKey(0)),
                             make_mesh(3, axis="link"))
        elif path == "simulate":
            make_link_sharded_simulate(scn, make_mesh(3, axis="link"), 2)
        else:
            mesh2d = make_mesh_2d(2, 3)
            states = jax.vmap(scn.init_state)(
                jax.random.split(jax.random.PRNGKey(0), 2))
            shard_hybrid_state(states, mesh2d)


def test_link_sharded_step_interactive_control():
    """make_link_sharded_step: the RL-control stepping path — mutate the
    gate surface between sharded steps (as a controller would), outputs
    must stay sharded and match the unsharded engine bitwise."""
    from pednstream_tpu.engine import step_fn
    from pednstream_tpu.parallel import make_link_sharded_step

    scn = _tiny_controller_scenario()
    ep = scn.engine_params
    mesh = make_mesh(8, axis="link")
    step_sh = make_link_sharded_step(scn, mesh, stochastic=False)
    ref_step = jax.jit(
        lambda e, s: step_fn(scn, e, s, stochastic=False, record=False)[0]
    )

    st_ref = scn.init_state(jax.random.PRNGKey(2))
    st_sh = shard_link_state(st_ref, mesh)
    for i in range(6):
        if i == 3:  # half-close every gate mid-run
            new_gate = (st_ref.back_gate * 0.5).astype(st_ref.back_gate.dtype)
            st_ref = st_ref.replace(back_gate=new_gate)
            st_sh = shard_link_state(st_sh.replace(back_gate=new_gate), mesh)
        st_ref = ref_step(ep, st_ref)
        st_sh = step_sh(ep, st_sh)
    assert st_sh.cum_in_ring.sharding.spec == P(None, "link")
    _assert_states_bitequal(st_ref, st_sh)


@pytest.mark.slow
def test_link_sharded_bitexact_real_dataset_with_routing():
    """two_coordinators (49 nodes, 168 directed links, routed turning
    fractions, separator controllers): the full per-step pipeline —
    dynamic logit routing, compact phi re-solve, node merge/diverge —
    under link sharding, bitwise equal to single-device."""
    from pednstream_tpu.generator import NetworkEnvGenerator

    gen = NetworkEnvGenerator()
    data = gen.load_network_data("two_coordinators")
    scn = build_scenario(
        data["adjacency_matrix"], gen.config["params"],
        gen.config["origin_nodes"], gen.config["destination_nodes"],
    )
    ep = scn.engine_params
    st = scn.init_state(jax.random.PRNGKey(7))
    steps = 15

    ref = jax.jit(  # ep as argument: see comment in the tiny test
        lambda e, s: simulate(scn, e, s, steps, stochastic=True,
                              record=False)[0]
    )(ep, st)

    mesh = make_mesh(8, axis="link")
    run = make_link_sharded_simulate(scn, mesh, steps, stochastic=True)
    out = run(ep, shard_link_state(st, mesh))
    _assert_states_bitequal(ref, out)


@pytest.mark.parametrize("stochastic", [False, True])
def test_hybrid_env_x_link_sharding_bitexact(stochastic):
    """2-D mesh (env=2 x link=4): replicas block over the DP axis, each
    replica's link axis blocks over the fast axis — the SURVEY §2.6
    pod-scale layout (DP over DCN x state over ICI) in one SPMD program.
    Must equal the unsharded batched engine BITWISE."""
    from pednstream_tpu.engine import simulate_batched
    from pednstream_tpu.parallel import (
        make_hybrid_sharded_simulate, make_mesh_2d, shard_hybrid_state,
    )

    scn = _tiny_controller_scenario()
    ep = scn.engine_params
    B, steps = 4, 25
    states = jax.vmap(scn.init_state)(
        jax.random.split(jax.random.PRNGKey(3), B))

    ref = jax.jit(  # ep as argument: see the tiny test above
        lambda e, s: simulate_batched(scn, e, s, steps,
                                      stochastic=stochastic)
    )(ep, states)

    mesh = make_mesh_2d(2, 4)
    run = make_hybrid_sharded_simulate(scn, mesh, steps,
                                       stochastic=stochastic)
    out = run(ep, shard_hybrid_state(states, mesh))

    assert out.cum_in_ring.sharding.spec == P("env", None, "link")
    assert len(out.density.sharding.device_set) == 8
    # per-device shard = (B/2, H, E/4)
    shard = out.cum_in_ring.addressable_shards[0]
    assert shard.data.shape == (B // 2, scn.H, scn.n_links // 4)
    _assert_states_bitequal(ref, out)


def _grid_adjacency(n: int) -> np.ndarray:
    """n x n 4-neighbour grid adjacency (the package's own generator)."""
    from pednstream_tpu.config import grid_adjacency

    return grid_adjacency(n, n)


@pytest.mark.xslow  # ~40s: builds + compiles a 108k-link network
def test_link_sharded_100k_link_grid():
    """The blueprint's motivating scale (SURVEY §2.6: '10k+-link
    networks', here at ~100k): a synthetic 165x165 grid with
    108,240 directed links, sharded 8 ways.

    Checks, in order of importance: (1) the rings are PHYSICALLY
    blockwise (per-device shard = E/8 lanes); (2) no collective in the
    optimized HLO materializes a full ring, i.e. per-chip memory really
    is O(E*H/P) + O(E) exchange; (3) a few steps execute and move mass;
    (4) sharded == unsharded bitwise at this scale too.
    """
    n = 165
    N = n * n
    adj = _grid_adjacency(n)
    params = {
        "simulation_steps": 60,
        "unit_time": 10,
        "seed": 0,
        "default_link": {
            "length": 80, "width": 3, "free_flow_speed": 1.2,
            "k_critical": 2, "k_jam": 6, "fd_type": "yperman", "bi_factor": 1,
        },
        "demand": {
            "origin_0": {"pattern": "constant", "base_lambda": 8},
            f"origin_{N - 1}": {"pattern": "constant", "base_lambda": 8},
        },
    }
    scn = build_scenario(
        adj, params, [0, N - 1], [n - 1, N - n], history_window=16,
    )
    E = scn.n_links
    assert E == 2 * 2 * n * (n - 1)  # 108,240 directed links
    ep = scn.engine_params
    st = scn.init_state(jax.random.PRNGKey(1))
    steps = 3

    mesh = make_mesh(8, axis="link")
    run = make_link_sharded_simulate(scn, mesh, steps, stochastic=False)

    # (2) memory claim, checked on the compiled HLO before running
    st_sh = shard_link_state(st, mesh)
    compiled = run.lower(ep, st_sh).compile()
    ring_bytes = scn.H * E * np.dtype(np.float32).itemsize
    n_coll, _ = assert_no_full_ring_collectives(compiled, ring_bytes)
    assert n_coll > 0, "expected cross-shard node-exchange collectives"

    out = compiled(ep, st_sh)
    # (1) physical blockwise layout
    shard = out.cum_in_ring.addressable_shards[0]
    assert shard.data.shape == (scn.H, E // 8)
    assert float(np.asarray(out.num_peds).sum()) > 0  # (3) mass moved

    # (4) bit-equality vs single device at scale (ep as argument: see
    # the tiny test)
    ref = jax.jit(
        lambda e, s: simulate(scn, e, s, steps, stochastic=False,
                              record=False)[0]
    )(ep, st)
    _assert_states_bitequal(ref, out)


class _FakeCompiled:
    """Stand-in for a jax Compiled object: only as_text() is consumed."""

    def __init__(self, hlo: str):
        self._hlo = hlo

    def as_text(self) -> str:
        return self._hlo


def test_ring_collective_guard_sees_variadic_and_async_forms():
    """The memory-claim guard must catch every HLO spelling a ring-sized
    collective can take — XLA's combiner passes emit TUPLE-shaped
    variadic all-reduce/all-gather, GSPMD can choose reduce-scatter, and
    async schedules split ops into -start/-done pairs.  The round-5
    review found the original regex blind to all three (a full ring
    hidden in a combined collective passed silently)."""
    ring = 16 * 108240 * 4  # H * E * f32

    # small collectives and ring-sized NON-collectives must pass
    n, v = assert_no_full_ring_collectives(_FakeCompiled("""
      %ag = f32[16,13530]{1,0} all-gather(f32[16,1692]{1,0} %p), replica_groups={}
      %cp = f32[108240]{0} collective-permute(f32[108240]{0} %x)
      %big = f32[16,108240]{1,0} fusion(f32[16,108240]{1,0} %y), calls=%fc
    """), ring)
    assert (n, v) == (2, 0)

    for label, hlo in [
        ("tuple all-reduce",
         "%ar.c = (f32[16,108240]{1,0}, f32[108240]{0}) "
         "all-reduce(f32[16,108240]{1,0} %a, f32[108240]{0} %b)"),
        ("reduce-scatter",
         "%rs = f32[16,108240]{1,0} reduce-scatter(f32[16,865920]{1,0} %a)"),
        ("async all-gather-start",
         "%ags = (f32[16,13530]{1,0}, f32[16,108240]{1,0}) "
         "all-gather-start(f32[16,13530]{1,0} %p)"),
    ]:
        with pytest.raises(AssertionError):
            assert_no_full_ring_collectives(_FakeCompiled(hlo), ring)
