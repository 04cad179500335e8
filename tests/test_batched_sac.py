"""BatchedSACTrainer: batched off-policy training (batched_sac.py).

Covers: a training iteration improves/updates state sanely, the replay
ring wraps, export produces host-format checkpoints that the existing
eval harness (build_agents + load_all_agents + validate_agents) loads
and runs unchanged, and the separator path trains (long_corridor).
Reference analog: rl/agents/SAC_copy.py:157-310 host training loop.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def env():
    from pednstream_tpu.env import PedNetParallelEnv

    return PedNetParallelEnv("butterfly_scC", action_gap=30, seed=0)


@pytest.fixture(scope="module")
def trained(env):
    from pednstream_tpu.rl.batched_sac import BatchedSACTrainer

    tr = BatchedSACTrainer(env.core, num_envs=8, collect_steps=4,
                           updates_per_iter=4, batch_size=32,
                           buffer_capacity=128, warmup_transitions=32,
                           randomize=True, randomize_fraction=0.5)
    ts = tr.init(jax.random.PRNGKey(0))
    metrics = []
    for _ in range(3):
        ts, m = tr.train_iteration(ts)
        metrics.append(m)
    return tr, ts, metrics


def test_iteration_metrics_finite_and_params_move(trained):
    tr, ts, metrics = trained
    for m in metrics:
        for k, v in m.items():
            assert np.isfinite(v), (k, v)
    assert metrics[-1]["buffer_size"] > 0
    # params actually updated once past warmup
    fresh = tr.init(jax.random.PRNGKey(0))
    moved = jax.tree_util.tree_reduce(
        lambda acc, x: acc + float(jnp.abs(x).sum()),
        jax.tree_util.tree_map(
            lambda a, b: a - b,
            ts.params["gate_2"]["actor"], fresh.params["gate_2"]["actor"]),
        0.0,
    )
    assert moved > 0.0


def test_replay_ring_wraps(trained):
    tr, ts, _ = trained
    # capacity 128, 8 envs x 4 steps x 3 iters = 96 written; run two more
    for _ in range(2):
        ts, _ = tr.train_iteration(ts)
    assert int(ts.size) == min(8 * 4 * 5, tr.cap) == 128
    assert int(ts.ptr) == (8 * 4 * 5) % 128


def test_export_loads_through_host_eval_harness(trained, env, tmp_path):
    from pednstream_tpu.rl.rl_utils import (
        RunningNormalizeWrapper,
        load_all_agents,
        validate_agents,
    )
    from pednstream_tpu.rl.train import build_agents

    tr, ts, _ = trained
    out = str(tmp_path / "ckpt")
    tr.export(ts, out, extra={"val_reward": -123.0})
    assert sorted(os.listdir(out)) == ["config.json", "gate_2.pkl",
                                       "norm_stats.json"]
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["extra"]["val_reward"] == -123.0
    assert cfg["agents"]["gate_2"]["algo"] == "sac"
    stats = json.load(open(os.path.join(out, "norm_stats.json")))
    assert "gate_2" in stats["obs_rms"] and "gate_2" in stats["ret_rms"]
    # running stats actually accumulated during collection
    assert stats["obs_rms"]["gate_2"]["count"] > 1

    wrapped = RunningNormalizeWrapper(env)
    agents = build_agents(wrapped, algo="sac", seed=0)
    load_all_agents(agents, out, env=wrapped)
    assert agents["gate_2"].gate_anchor == "open"
    score = validate_agents(wrapped, agents, num_episodes=1)
    assert np.isfinite(score)


def test_exported_actor_params_match_trainer(trained, tmp_path):
    import pickle

    tr, ts, _ = trained
    out = str(tmp_path / "ckpt2")
    tr.export(ts, out)
    with open(os.path.join(out, "gate_2.pkl"), "rb") as f:
        blob = pickle.load(f)
    want = jax.device_get(ts.params["gate_2"]["actor"])
    got = blob["actor"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        want, got)


@pytest.mark.xslow
def test_separator_scenario_trains_and_exports(tmp_path):
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_sac import BatchedSACTrainer

    env = PedNetParallelEnv("long_corridor", action_gap=30, seed=0)
    tr = BatchedSACTrainer(env.core, num_envs=4, collect_steps=2,
                           updates_per_iter=2, batch_size=16,
                           buffer_capacity=64, warmup_transitions=8)
    ts = tr.init(jax.random.PRNGKey(1))
    ts, m = tr.train_iteration(ts)
    assert all(np.isfinite(v) for v in m.values())
    out = str(tmp_path / "sep")
    tr.export(ts, out)
    names = sorted(os.listdir(out))
    assert any(n.startswith("sep_") and n.endswith(".pkl") for n in names)


def test_randomize_fraction_keeps_nominal_replicas(env):
    from pednstream_tpu.rl.batched_sac import BatchedSACTrainer

    tr = BatchedSACTrainer(env.core, num_envs=8, randomize=True,
                           randomize_fraction=0.5)
    ts = tr.init(jax.random.PRNGKey(2))
    nominal = env.core.scn.engine_params
    # replicas [n_rand:] carry the scenario's NOMINAL world
    for leaf, nom in zip(jax.tree_util.tree_leaves(ts.engine_params),
                         jax.tree_util.tree_leaves(nominal)):
        a = np.asarray(leaf)[4:]
        np.testing.assert_array_equal(
            a, np.broadcast_to(np.asarray(nom), a.shape))
