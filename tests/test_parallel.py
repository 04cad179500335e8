"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(tests/conftest.py forces --xla_force_host_platform_device_count=8).

Covers the SPMD replacement for the reference's Ray rollout workers
(rl/train_ppo_rllib.py:62-64): mesh construction, batch sharding
placement, the sharded data-parallel train step, and a mesh-sharded
BatchedPPOTrainer iteration whose results must match the unsharded run
(same logical program, GSPMD only changes the partitioning).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pednstream_tpu.env import PedNetEnvCore, build_agent_spec
from pednstream_tpu.parallel import data_parallel_env_step, make_mesh, shard_batch
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


@pytest.fixture(scope="module")
def core():
    scn = _tiny_controller_scenario()
    spec = build_agent_spec(scn)
    return PedNetEnvCore(scn, spec, obs_mode="option2", stochastic=True)


def test_make_mesh_and_shard_batch(core):
    assert len(jax.devices()) >= 8, "conftest must expose 8 virtual devices"
    mesh = make_mesh(8)
    assert mesh.devices.shape == (8,)

    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    states, obs = core.batch_reset(keys)
    states = shard_batch(states, mesh)
    # leading batch axis sharded over the env axis, 2 replicas per device
    assert len(states.density.sharding.device_set) == 8
    assert states.density.sharding.spec == P("env")
    # scalar-per-replica leaves shard too; nothing is left on one device
    assert len(states.t.sharding.device_set) == 8


def test_make_mesh_raises_on_too_few_devices():
    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(n + 1)
    assert make_mesh(n).devices.shape == (n,)


@pytest.mark.slow
def test_sharded_env_step_matches_unsharded(core):
    mesh = make_mesh(8)
    B = 16
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    states, obs = core.batch_reset(keys)

    widths = np.asarray(core.spec.gate_link_widths[0], np.float32)
    actions = {core.spec.gate_ids[0]: jnp.tile(widths[None], (B, 1))}

    st_plain, obs_plain, rew_plain, done_plain = core.batch_step(states, actions)

    sharded_step = data_parallel_env_step(core, mesh)
    st_sh, obs_sh, rew_sh, done_sh = sharded_step(
        shard_batch(states, mesh), shard_batch(actions, mesh)
    )
    gid = core.spec.gate_ids[0]
    np.testing.assert_allclose(
        np.asarray(rew_plain[gid]), np.asarray(rew_sh[gid]), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st_plain.density), np.asarray(st_sh.density), rtol=1e-6
    )


@pytest.mark.slow
def test_dp_train_step_replicates_params(core):
    from pednstream_tpu.rl.train import init_train_state, make_dp_train_step

    mesh = make_mesh(8)
    B = 16
    states, obs = core.batch_reset(jax.random.split(jax.random.PRNGKey(2), B))
    states = shard_batch(states, mesh)
    obs = shard_batch(obs, mesh)

    train_state = init_train_state(core, jax.random.PRNGKey(3))
    dp_step = make_dp_train_step(core, mesh)
    new_states, new_obs, train_state, metrics = dp_step(states, obs, train_state)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    # params come back fully replicated (a single logical copy on all devices)
    leaf = jax.tree_util.tree_leaves(train_state["params"])[0]
    assert len(leaf.sharding.device_set) == 8
    assert leaf.sharding.is_fully_replicated
    # env states stayed sharded over the env axis
    assert new_states.density.sharding.spec == P("env")


@pytest.mark.slow
def test_mesh_sharded_batched_ppo_matches_unsharded(core):
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer

    mesh = make_mesh(8)
    kw = dict(num_envs=16, rollout_len=4, epochs=2, minibatches=2)

    t_plain = BatchedPPOTrainer(core, **kw)
    ts_plain = t_plain.init(jax.random.PRNGKey(4))
    ts_plain, m_plain = t_plain.train_iteration(ts_plain)

    # the TRAINER establishes shardings: init places the batch axis over
    # the mesh's env axis and replicates params; the caller passes plain
    # state through unchanged
    t_mesh = BatchedPPOTrainer(core, mesh=mesh, **kw)
    ts_mesh = t_mesh.init(jax.random.PRNGKey(4))
    assert ts_mesh.env_states.density.sharding.spec == P("env")
    p_leaf = jax.tree_util.tree_leaves(ts_mesh.params)[0]
    assert p_leaf.sharding.is_fully_replicated
    ts_mesh, m_mesh = t_mesh.train_iteration(ts_mesh)
    # the iteration keeps the layout: env state stays sharded, params
    # replicated, across the full rollout + minibatch-update program
    assert len(ts_mesh.env_states.density.sharding.device_set) == 8
    p_leaf = jax.tree_util.tree_leaves(ts_mesh.params)[0]
    assert p_leaf.sharding.is_fully_replicated

    # GSPMD partitioning must not change the math: same losses, same
    # updated parameters as the single-device run
    for k in m_plain:
        assert np.isfinite(m_mesh[k])
        np.testing.assert_allclose(m_plain[k], m_mesh[k], rtol=1e-4, atol=1e-6)
    p_plain = jax.tree_util.tree_leaves(ts_plain.params)
    p_mesh = jax.tree_util.tree_leaves(ts_mesh.params)
    for a, b in zip(p_plain, p_mesh):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.xslow
def test_mesh_sharded_batched_sac_matches_unsharded(core):
    from pednstream_tpu.rl.batched_sac import BatchedSACTrainer

    mesh = make_mesh(8)
    kw = dict(num_envs=16, collect_steps=3, updates_per_iter=4,
              batch_size=32, buffer_capacity=256, warmup_transitions=16)

    t_plain = BatchedSACTrainer(core, **kw)
    ts_plain = t_plain.init(jax.random.PRNGKey(5))
    ts_plain, m_plain = t_plain.train_iteration(ts_plain)

    t_mesh = BatchedSACTrainer(core, mesh=mesh, **kw)
    ts_mesh = t_mesh.init(jax.random.PRNGKey(5))
    assert ts_mesh.env_states.density.sharding.spec == P("env")
    buf_leaf = ts_mesh.buffers["gate_2"]["s"]
    assert buf_leaf.sharding.is_fully_replicated  # ring is capacity-axis
    ts_mesh, m_mesh = t_mesh.train_iteration(ts_mesh)
    assert len(ts_mesh.env_states.density.sharding.device_set) == 8
    p_leaf = jax.tree_util.tree_leaves(ts_mesh.params)[0]
    assert p_leaf.sharding.is_fully_replicated

    # unlike the PPO trainer, collection reduces ACROSS replicas (running
    # obs/return moments), so GSPMD's cross-device reduction order shifts
    # results by a few ulp (measured max 4e-6 after one iteration) —
    # compare at 1e-4, not bit-exact
    for k in m_plain:
        assert np.isfinite(m_mesh[k])
        np.testing.assert_allclose(m_plain[k], m_mesh[k], rtol=1e-4, atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(ts_plain.params),
                    jax.tree_util.tree_leaves(ts_mesh.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
