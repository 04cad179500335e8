"""Unit tests for FD functions, flow conservation, IO round-trip, offline
metrics, engine checkpointing, and the MCP tool surface."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _tiny_scenario(T=60, **over):
    from pednstream_tpu import build_scenario

    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    params = {
        "unit_time": 10, "simulation_steps": T, "seed": 1,
        "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6},
        "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
    }
    params.update(over)
    return build_scenario(adj, params, origin_nodes=[0], destination_nodes=[3])


def test_fd_functions():
    from pednstream_tpu.fd import speed_from_density
    from pednstream_tpu.topology import FD_TYPES

    k = jnp.float32(np.array([0.5, 2.0, 4.0, 6.0]))
    vf = jnp.full(4, 1.1)
    kc = jnp.full(4, 2.0)
    kj = jnp.full(4, 6.0)

    # yperman: v = v_f below k_c; (k_c*v_f)/(k_j-k_c) * (k_j/k - 1) above
    v = speed_from_density(k, vf, kc, kj, jnp.full(4, FD_TYPES["yperman"]))
    np.testing.assert_allclose(v[:2], [1.1, 1.1], rtol=1e-6)
    expected = (2 * 1.1) / 4 * (6 / 4 - 1)
    np.testing.assert_allclose(v[2], expected, rtol=1e-5)
    assert v[3] == 0.0  # jam density -> zero speed

    # greenshields above k_c: -v_f (k - k_j)/(k_j - k_c)
    v = speed_from_density(k, vf, kc, kj, jnp.full(4, FD_TYPES["greenshields"]))
    np.testing.assert_allclose(v[2], -1.1 * (4 - 6) / 4, rtol=1e-5)

    # smulders below k_c: v_f (1 - k/k_j)
    v = speed_from_density(k, vf, kc, kj, jnp.full(4, FD_TYPES["smulders"]))
    np.testing.assert_allclose(v[0], 1.1 * (1 - 0.5 / 6), rtol=1e-5)


def test_mass_conservation():
    """cum_in - cum_out == num_pedestrians on every link, and network
    totals balance origin departures vs destination arrivals."""
    from pednstream_tpu.engine import simulate

    scn = _tiny_scenario()
    final, _ = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                        scn.simulation_steps - 1, stochastic=True, record=False)
    ci, co = np.asarray(final.cum_in), np.asarray(final.cum_out)
    peds = np.asarray(final.num_peds)
    np.testing.assert_allclose(ci - co, peds, atol=1e-4)
    # global balance: departures = in-network + arrivals
    dep = float(np.asarray(final.virt_dep_cum).sum())
    arr = float(np.asarray(final.virt_arr_cum).sum())
    assert abs(dep - (peds.sum() + arr)) < 1e-3


def test_untracked_inflow_ring_same_dynamics():
    """track_inflow_ring=False skips the diagnostic inflow-ring row write
    on the stochastic fast path (its unread dynamic-update-slice cost ~20%
    of the melbourne bench step) — dynamics must be bit-identical, the
    ring must stay zeros, and deterministic mode must keep maintaining the
    ring regardless (its diffusion path reads it in-loop)."""
    from pednstream_tpu.engine import simulate

    scn = _tiny_scenario()
    ep = scn.engine_params
    st0 = scn.init_state(jax.random.PRNGKey(3))
    outs = {}
    for track in (True, False):
        scn.track_inflow_ring = track
        outs[track], _ = jax.jit(
            lambda s: simulate(scn, ep, s, 50, stochastic=True, record=False)
        )(st0)
    np.testing.assert_array_equal(np.asarray(outs[True].num_peds),
                                  np.asarray(outs[False].num_peds))
    np.testing.assert_array_equal(np.asarray(outs[True].cum_in),
                                  np.asarray(outs[False].cum_in))
    assert np.abs(np.asarray(outs[False].inflow_ring)).max() == 0.0
    assert np.abs(np.asarray(outs[True].inflow_ring)).max() > 0.0

    # deterministic mode reads the ring in-loop -> flag must be ignored
    scn.track_inflow_ring = False
    fin_d, _ = jax.jit(
        lambda s: simulate(scn, ep, s, 50, stochastic=False, record=False)
    )(st0)
    assert np.abs(np.asarray(fin_d.inflow_ring)).max() > 0.0


def test_compact_routing_matches_dense():
    """The fast routed-phi path keeps phi compact over the NR routed nodes
    and re-solves just those rows in _node_solve (routing.py compact=True);
    the classic solve is row-local per node, so this must equal the dense
    [N, M, M] computation exactly — both at the phi level and at the
    node-solve flow level."""
    from pednstream_tpu.engine import _node_solve
    from pednstream_tpu.generator import NetworkEnvGenerator
    from pednstream_tpu.routing import turning_fractions_step

    gen = NetworkEnvGenerator()
    scn = gen.create_network("butterfly_scC")
    rt = scn.routing
    assert rt is not None and 0 < rt.num_routed < scn.n_nodes
    ep = scn.engine_params
    f = scn.ftype
    rng = np.random.RandomState(3)
    E = scn.n_links
    density = jnp.asarray(rng.uniform(0, 8, E).astype(f))
    recv_prev = jnp.asarray(rng.uniform(-1, 30, E).astype(f))
    cap_default = jnp.asarray(rng.uniform(1, 40, E).astype(f))
    od_flow_t = jnp.asarray(ep.od_table[:, 5])
    args = (rt, scn.n_nodes, scn.max_deg, scn.node_arity, scn.slot_valid,
            density, recv_prev, cap_default, od_flow_t, ep.phi_base)

    phi_dense = turning_fractions_step(*args, exact=False, compact=False)
    phi_c = turning_fractions_step(*args, exact=False, compact=True)
    ids = np.asarray(rt.routed_ids)
    np.testing.assert_array_equal(np.asarray(phi_dense)[ids], np.asarray(phi_c))
    unrouted = ~np.asarray(rt.routed_mask)
    np.testing.assert_array_equal(np.asarray(phi_dense)[unrouted],
                                  np.asarray(ep.phi_base)[unrouted])

    st = scn.init_state(jax.random.PRNGKey(0))
    S = jnp.asarray(rng.uniform(0, 20, E).astype(f))
    R = jnp.asarray(rng.uniform(0, 20, E).astype(f))
    out_dense = _node_solve(scn, ep, st, 5, S, R, phi_dense, phi_c=None)
    out_compact = _node_solve(scn, ep, st, 5, S, R, ep.phi_base, phi_c=phi_c)
    for a, b in zip(out_dense, out_compact):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_output_roundtrip_and_metrics(tmp_path):
    from pednstream_tpu.engine import simulate
    from pednstream_tpu.io import OutputHandler
    from pednstream_tpu.rl.metrics import evaluate_run

    scn = _tiny_scenario()
    # run through t = T (as the RL env does) so the final cumulative
    # column — which the offline metrics read — is populated
    final, traj = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                           scn.simulation_steps, stochastic=False, record=True)
    handler = OutputHandler(base_dir=str(tmp_path), simulation_dir="run")
    handler.save_scenario_state(scn, traj, save_time_series=True)

    data = OutputHandler.load_simulation(str(tmp_path / "run"))
    assert set(data) >= {"link_data", "node_data", "network_params"}
    T = scn.simulation_steps
    dens = data["link_data"]["0-1"]["density"]
    assert len(dens) == T + 1
    np.testing.assert_allclose(
        dens[1 : T + 1], np.asarray(traj.density)[:, scn.topo.link_id_to_idx[(0, 1)]]
    )

    m = evaluate_run(str(tmp_path / "run"))
    assert 0 <= m["throughput"]["throughput"] <= 1.2
    assert m["travel_time"]["avg_travel_time"] > 0
    assert m["served_trips"]["total_inflow"] > 0
    assert m["congestion"]["total_area_time"] > 0


def test_engine_checkpoint_roundtrip(tmp_path):
    from pednstream_tpu.engine import simulate
    from pednstream_tpu.utils import load_engine_state, save_engine_state

    scn = _tiny_scenario()
    st = scn.init_state(jax.random.PRNGKey(0))
    st, _ = simulate(scn, scn.engine_params, st, 20, stochastic=True, record=False)
    path = str(tmp_path / "snap.npz")
    save_engine_state(st, path)
    restored = load_engine_state(path, scn.init_state(jax.random.PRNGKey(0)))
    # continuing from the snapshot reproduces the original trajectory
    a, _ = simulate(scn, scn.engine_params, st, 20, stochastic=True, record=False)
    b, _ = simulate(scn, scn.engine_params, restored, 20, stochastic=True, record=False)
    np.testing.assert_array_equal(np.asarray(a.density), np.asarray(b.density))


def test_windowed_mode_runs():
    from pednstream_tpu.engine import simulate

    scn = _tiny_scenario()
    from pednstream_tpu import build_scenario

    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    scn_w = build_scenario(adj, scn.params, [0], [3], history_window=16)
    assert scn_w.H == 16
    final, _ = simulate(scn_w, scn_w.engine_params,
                        scn_w.init_state(jax.random.PRNGKey(0)), 59,
                        stochastic=False, record=False)
    peds = np.asarray(final.num_peds)
    assert np.all(peds >= 0) and peds.sum() > 0


def test_mcp_tools(tmp_path):
    from pednstream_tpu.mcp import server

    r = server.create_environment("nine_intersections")
    assert r["status"] == "CREATED", r
    sid = r["sim_id"]
    r = server.run_simulation(sid, steps=10)
    assert r["current_step"] == 10
    r = server.run_simulation(sid, until=25)
    assert r["current_step"] == 25
    server._manager.base_output_dir = tmp_path
    out = server.save_outputs(sid)
    assert os.path.exists(os.path.join(out["output_dir"], "link_data.json"))
    assert server.get_status(sid)["status"] in ("CREATED", "COMPLETED")
    assert server.cancel_simulation(sid)["status"] == "CANCELLED"

    v = server.validate_config(yaml_text="network: {origin_nodes: [0]}")
    assert not v["valid"]
    v = server.validate_config(yaml_text=server.list_config_schema()["example_yaml"])
    assert v["valid"], v


def test_scripted_agent_client():
    from pednstream_tpu.mcp.agent_client import SimulationAgent
    from pednstream_tpu.mcp.assistant_harness import ScriptedAssistant

    script = [
        {"tool_calls": [{"name": "list_config_schema", "arguments": {}}]},
        {"tool_calls": [{"name": "validate_config", "arguments": {
            "yaml_text": "network:\n  origin_nodes: [0]\n"}}]},
        {"text": "done", "tool_calls": []},
    ]
    agent = SimulationAgent(ScriptedAssistant(script))
    transcript = agent.run("check the schema")
    tools_called = [e["tool"] for e in transcript if "tool" in e]
    assert tools_called == ["list_config_schema", "validate_config"]


def test_batched_ppo_trainer():
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0,
                            action_gap=5)
    tr = BatchedPPOTrainer(env.core, num_envs=8, rollout_len=4,
                           minibatches=2, epochs=1)
    ts = tr.init(jax.random.PRNGKey(0))
    ts, m = tr.train_iteration(ts)
    assert "gate_2/loss" in m and np.isfinite(m["gate_2/loss"])
    assert int(ts.iteration) == 1
    # params actually changed
    import jax.tree_util as jtu

    ts2, _ = tr.train_iteration(ts)
    diff = jtu.tree_reduce(
        lambda acc, x: acc + float(jnp.abs(x).sum()),
        jtu.tree_map(lambda a, b: a - b, ts.params["gate_2"], ts2.params["gate_2"]),
        0.0,
    )
    assert diff > 0


@pytest.mark.xslow
def test_batched_ppo_recurrent_randomized():
    """The reference's default attention-LSTM family trained through the
    batched path (PPO_backup.py:597-760 via rl/networks.py), with
    per-replica domain-randomized worlds (env_loader.py:160-424 analog)."""
    import jax.tree_util as jtu

    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.batched_ppo import BatchedPPOTrainer

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0,
                            action_gap=5)
    tr = BatchedPPOTrainer(env.core, num_envs=8, rollout_len=4,
                           minibatches=2, epochs=2, net_type="attention",
                           randomize=True)
    ts = tr.init(jax.random.PRNGKey(0))

    # every replica simulates its own randomized world
    ffs = np.asarray(ts.engine_params.free_flow_speed)
    assert ffs.shape[0] == 8
    assert not np.allclose(ffs[0], ffs[1])
    # derived constants track the perturbation per replica
    tt0 = np.asarray(ts.engine_params.travel_time0)
    assert not np.allclose(tt0[0], tt0[1])

    # recurrent carry is batched and evolves across iterations
    c0 = jtu.tree_leaves(ts.actor_carry["gate_2"])[0]
    assert c0.shape[0] == 8
    ts1, m1 = tr.train_iteration(ts)
    c1 = jtu.tree_leaves(ts1.actor_carry["gate_2"])[0]
    assert float(np.abs(np.asarray(c1)).sum()) > 0  # carry moved off zeros
    assert np.isfinite(m1["gate_2/loss"]) and np.isfinite(m1["gate_2/kl"])

    ts2, m2 = tr.train_iteration(ts1)
    diff = jtu.tree_reduce(
        lambda acc, x: acc + float(jnp.abs(x).sum()),
        jtu.tree_map(lambda a, b: a - b, ts1.params["gate_2"], ts2.params["gate_2"]),
        0.0,
    )
    assert diff > 0


def test_network_facade():
    """Reference-style OO driving (pednstream_tpu.Network) matches the
    functional engine and enforces sequential stepping."""
    from pednstream_tpu import Network, build_scenario
    from pednstream_tpu.engine import simulate

    adj = np.zeros((4, 4), dtype=int)
    for a, b in [(0, 1), (1, 2), (2, 3)]:
        adj[a, b] = adj[b, a] = 1
    params = {
        "unit_time": 10, "simulation_steps": 40, "seed": 1,
        "default_link": {"length": 100, "width": 2, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6},
        "demand": {"origin_0": {"peak_lambda": 15, "base_lambda": 5}},
    }
    net = Network(adj, params, origin_nodes=[0], destination_nodes=[3],
                  stochastic=False)
    for t in range(1, 40):
        net.network_loading(t)

    scn = build_scenario(adj, params, [0], [3])
    final, traj = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                           39, stochastic=False, record=True)
    e = scn.topo.link_id_to_idx[(0, 1)]
    np.testing.assert_allclose(
        net.links[(0, 1)].density[1:40], np.asarray(traj.density)[:, e]
    )
    with pytest.raises(ValueError):
        net.network_loading(7)


def test_randomized_batched_env():
    """Per-replica domain randomization rides EngineParams in-vmap:
    replicas with different link incidents and demand levels diverge even
    in deterministic mode."""
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.randomize import randomize_engine_params_batched

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0,
                            stochastic=False, history_window=32)
    B = 4
    eps = randomize_engine_params_batched(env.scn, jax.random.PRNGKey(3), B)
    assert np.asarray(eps.k_critical).shape[0] == B
    # parameters actually differ across replicas
    kc = np.asarray(eps.free_flow_speed)
    assert not np.allclose(kc[0], kc[1])

    states, obs = env.core.batch_reset(jax.random.split(jax.random.PRNGKey(0), B))
    widths = np.tile(env.spec_agents.gate_link_widths[0][None].astype(np.float32), (B, 1))
    actions = {"gate_2": widths}
    for _ in range(25):
        states, obs, rew, done = env.core.batch_step_randomized(states, actions, eps)
    dens = np.asarray(states.density)
    assert not np.allclose(dens[0], dens[1])  # different worlds -> different flows


def test_agent_checkpoint_roundtrip(tmp_path):
    """PPO/SAC save/load preserves parameters and policies
    (rl_utils.py:499-763 checkpoint semantics)."""
    from pednstream_tpu.rl import PPOAgent, SACAgent

    obs = np.random.RandomState(0).rand(20).astype(np.float32)

    a = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                 net_type="attention", seed=1)
    act_before = a.take_action(obs, explore=False)
    a.save(str(tmp_path / "ppo.pkl"))
    b = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                 net_type="attention", seed=99)
    b.load(str(tmp_path / "ppo.pkl"))
    b.reset_hidden()
    np.testing.assert_allclose(b.take_action(obs, explore=False), act_before,
                               rtol=1e-6)

    s = SACAgent(obs_dim=20, act_dim=5, seed=1)
    act_s = s.take_action(obs, explore=False)
    s.save(str(tmp_path / "sac.pkl"))
    s2 = SACAgent(obs_dim=20, act_dim=5, seed=7)
    s2.load(str(tmp_path / "sac.pkl"))
    s2.reset_hidden()
    np.testing.assert_allclose(s2.take_action(obs, explore=False), act_s,
                               rtol=1e-6)


def test_agent_checkpoint_load_rebuilds_architecture(tmp_path):
    """Loading a checkpoint whose recorded net_type differs from the
    receiving agent's rebuilds the module tree (the lstm_ppo zoo
    variant is validated/evaluated through build_agents, which defaults
    to attention; params applied to the wrong tree raised
    ScopeParamNotFoundError)."""
    from pednstream_tpu.rl import PPOAgent

    obs = np.random.RandomState(0).rand(20).astype(np.float32)
    a = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                 net_type="lstm", seed=1)
    act_before = a.take_action(obs, explore=False)
    a.save(str(tmp_path / "lstm.pkl"))

    b = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                 net_type="attention", seed=99)
    b.load(str(tmp_path / "lstm.pkl"))
    assert b.net_type == "lstm"
    b.reset_hidden()
    np.testing.assert_allclose(b.take_action(obs, explore=False), act_before,
                               rtol=1e-6)

    # SAC: the gate-anchor mode travels with the checkpoint the same way
    from pednstream_tpu.rl import SACAgent

    s = SACAgent(obs_dim=20, act_dim=5, action_low=np.zeros(5),
                 action_high=np.full(5, 3.0), seed=1)
    s.gate_anchor = "open"
    s.save(str(tmp_path / "sac.pkl"))
    s2 = SACAgent(obs_dim=20, act_dim=5, action_low=np.zeros(5),
                  action_high=np.full(5, 3.0), seed=2)
    s2.load(str(tmp_path / "sac.pkl"))
    assert s2.gate_anchor == "open"
    # open anchor: zero delta -> full-open widths, not obs-derived ones
    np.testing.assert_allclose(
        s2.absolute_action(obs, np.zeros(5, np.float32)), np.full(5, 3.0))


@pytest.mark.slow
def test_udlstm_and_gat_policy_families():
    """The two remaining reference families: UD-LSTM
    (PPO_backup.py:419-596) and GAT-LSTM with a real controlled-links
    adjacency (PPO_backup.py:126-353) — take_action + update smoke."""
    from pednstream_tpu.rl import PPOAgent

    rng = np.random.RandomState(0)
    for net, kw in [("udlstm", {}),
                    ("gat", {"adj": np.array([[1, 1, 0, 0, 0],
                                              [1, 1, 1, 0, 0],
                                              [0, 1, 1, 1, 0],
                                              [0, 0, 1, 1, 1],
                                              [0, 0, 0, 1, 1]], np.float32)})]:
        a = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                     net_type=net, epochs=2, seed=3, **kw)
        obs = rng.rand(20).astype(np.float32)
        d1 = a.take_action(obs, explore=False)
        assert d1.shape == (5,) and np.all(np.isfinite(d1))
        # recurrent: same obs, evolved hidden -> different output
        d2 = a.take_action(obs, explore=False)
        assert not np.allclose(d1, d2), net
        for t in range(6):
            o = rng.rand(20).astype(np.float32)
            a.store_transition(o, a.take_action(o), -1.0, t == 5)
        m = a.update()
        assert np.isfinite(m["actor_loss"]) and np.isfinite(m["critic_loss"]), net

    # the GAT adjacency must actually mask attention: different adj,
    # same params -> different action
    base = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                    net_type="gat", seed=3)
    masked = PPOAgent(obs_dim=20, act_dim=5, features_per_link=4,
                      net_type="gat", seed=3,
                      adj=np.eye(5, dtype=np.float32))
    masked.actor_params = base.actor_params
    obs = rng.rand(20).astype(np.float32)
    assert not np.allclose(base.take_action(obs, explore=False),
                           masked.take_action(obs, explore=False))


def test_build_agents_gat_adjacency_wired():
    """build_agents passes the controlled-links adjacency to GAT gaters
    (was accepted but never supplied in round 1)."""
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.train import build_agents

    env = PedNetParallelEnv("butterfly_scC", obs_mode="option2", seed=0,
                            action_gap=10)
    agents = build_agents(env, algo="ppo", net_type="gat")
    gate = agents["gate_2"]
    assert gate.adj is not None
    L = gate.act_dim
    assert gate.adj.shape == (L, L)
    # all controlled links leave node 2, so they all share an endpoint
    assert np.all(np.asarray(gate.adj) == 1.0)
    obs, _ = env.reset()
    d = gate.take_action(obs["gate_2"], explore=False)
    assert d.shape == (L,) and np.all(np.isfinite(d))


def test_interactive_html_export(tmp_path):
    """Standalone interactive HTML map (dashboard/viz parity: replaces the
    reference's Streamlit+folium+Selenium stack with a zero-dependency
    artifact): embeds SVG geometry, quantized per-property frames, and
    the slider/play controls."""
    import json as _json
    import re

    from pednstream_tpu.engine import simulate
    from pednstream_tpu.generator import NetworkEnvGenerator
    from pednstream_tpu.viz import export_interactive_html

    gen = NetworkEnvGenerator()
    scn = gen.create_network("butterfly_scC")
    _, outs = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                       25, stochastic=True, record=True)
    history = [jax.tree_util.tree_map(lambda x: x[i], outs) for i in range(25)]
    out = str(tmp_path / "map.html")
    export_interactive_html(scenario=scn, history=history, out_path=out)
    html = open(out).read()
    # geometry: one SVG line per directed link
    assert html.count("<line id=") == scn.n_links
    # controls + script present
    for frag in ('<input type="range"', "function render()", "<select id=\"prop\">"):
        assert frag in html, frag
    # embedded data: density frames cover the recorded steps
    data = _json.loads(re.search(r"const DATA = (\{.*?\});", html).group(1))
    assert "density" in data and "speed" in data
    assert len(data["density"][0]) == scn.n_links
    assert all(0 <= v <= 255 for v in data["density"][-1])


def test_validate_agents_converts_deltas_to_absolute():
    """validate_agents must step the env with ABSOLUTE widths, not raw
    policy deltas (the reference converts, rl_utils.py:332-341).  A
    zero-delta open-anchored agent is behaviorally identical to
    no-control, so their validation totals must match exactly — before
    the fix the raw near-zero deltas were applied as near-closed gate
    widths and scored 4x worse."""
    from pednstream_tpu.env import PedNetParallelEnv
    from pednstream_tpu.rl.ppo import PPOAgent
    from pednstream_tpu.rl.rl_utils import validate_agents
    from pednstream_tpu.rl.train import build_agents

    def fresh_env():
        # one env per validation: the env PRNG advances across resets,
        # so sharing an instance would give different stochastic draws
        return PedNetParallelEnv("butterfly_scC", obs_mode="option2",
                                 seed=7, action_gap=15, history_window=64)

    env = fresh_env()
    aid = env.possible_agents[0]
    space = env.action_space(aid)
    obs_space = env.observation_space(aid)

    agent = PPOAgent(obs_dim=int(np.prod(obs_space.shape)),
                     act_dim=int(np.prod(space.shape)),
                     features_per_link=4, net_type="mlp",
                     action_low=space.low, action_high=space.high)
    agent.gate_anchor = "open"
    agent.take_action = lambda obs, explore=True: np.zeros(
        int(np.prod(space.shape)), np.float32)

    total_zero_delta = validate_agents(env, {aid: agent}, num_episodes=1)
    env2 = fresh_env()
    nc = build_agents(env2, algo="no_control")
    total_nc = validate_agents(env2, nc, num_episodes=1)
    assert total_zero_delta == total_nc
