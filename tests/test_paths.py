"""The in-package shortest-path port against NetworkX: the OD path sets
and controller detours of every bundled routed dataset must come out
identical, tie-breaking included (the reference enumerates with
NetworkX)."""

import glob
import os
import types

import pytest

from pednstream_tpu import paths, routing
from pednstream_tpu.generator import NetworkEnvGenerator
from pednstream_tpu.topology import parse_controllers

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
DATASETS = sorted(os.path.basename(os.path.dirname(p))
                  for p in glob.glob(os.path.join(DATA, "*", "sim_params.yaml")))


def _networkx_module():
    """A stand-in for ``routing.nxp`` backed by NetworkX itself."""
    nx = pytest.importorskip("networkx")

    class Weights:
        def __init__(self, g):
            self.g = g

        def __getitem__(self, edge):
            return self.g.edges[edge]["weight"]

        def __setitem__(self, edge, value):
            self.g.edges[edge]["weight"] = value

    class DiGraph(nx.DiGraph):
        def add_edge(self, u, v, weight=1.0):
            super().add_edge(u, v, weight=weight)

        @property
        def weight(self):
            return Weights(self)

    return types.SimpleNamespace(
        DiGraph=DiGraph, NoPath=nx.NetworkXNoPath,
        shortest_simple_paths=lambda G, s, t: nx.shortest_simple_paths(
            G, s, t, weight="weight"),
        shortest_path_length=lambda G, s, t: nx.shortest_path_length(
            G, s, t, weight="weight"),
    )


@pytest.mark.parametrize("dataset", DATASETS)
def test_path_sets_match_networkx(dataset, monkeypatch):
    gen = NetworkEnvGenerator()
    scn = gen.create_network(dataset)
    mine = scn.path_builder
    assert mine is not None and mine.od_paths

    params = gen.config["params"]
    _, ctrl_nodes, _, ctrl_links = parse_controllers(params)
    monkeypatch.setattr(routing, "nxp", _networkx_module())
    ref = routing.PathSetBuilder(scn.topo, params, ctrl_nodes, ctrl_links)
    ref.find_od_paths(list(mine.od_paths))

    assert mine.od_paths == ref.od_paths
    assert mine.node_to_od_pairs == ref.node_to_od_pairs


def test_yen_tie_breaking_and_no_path():
    g = paths.DiGraph()
    # two equal-length routes 0->1->3 and 0->2->3, and a longer 0->3
    for u, v, w in [(0, 1, 1.0), (0, 2, 1.0), (1, 3, 1.0), (2, 3, 1.0),
                    (0, 3, 5.0)]:
        g.add_edge(u, v, w)
    g.add_edge(4, 0, 1.0)
    got = list(paths.shortest_simple_paths(g, 0, 3))
    assert got == [[0, 1, 3], [0, 2, 3], [0, 3]]
    assert paths.shortest_path_length(g, 0, 3) == 2.0
    with pytest.raises(paths.NoPath):
        paths.shortest_path_length(g, 3, 0)
    with pytest.raises(paths.NoPath):
        next(paths.shortest_simple_paths(g, 3, 4))
