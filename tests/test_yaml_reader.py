"""The in-package YAML reader against PyYAML's safe_load."""

import glob
import os

import pytest

from pednstream_tpu.yaml_reader import safe_load

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
SCENARIOS = sorted(os.path.basename(os.path.dirname(p))
                   for p in glob.glob(os.path.join(DATA, "*", "sim_params.yaml")))


def test_all_bundled_scenarios_found():
    assert len(SCENARIOS) == 14


@pytest.mark.parametrize("name", SCENARIOS)
def test_bundled_scenario_matches_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    path = os.path.join(DATA, name, "sim_params.yaml")
    with open(path) as f:
        want = yaml.safe_load(f)
    with open(path) as f:
        assert safe_load(f) == want


SUBSET = """\
# comment line
a: [1, 2.5, 'x y', "q\\"z", [], {}, {k: v, n: [1, {m: 2}]}]
b:
- - 0
  - 1
- - 2
- key: 1
  other: null
- ~
c: 0x1F
d: 017
e: 1e-5
f: 1.0e-05
g: -.inf
h: yes
i: 'it''s # not a comment'  # a comment
j: it's
k: 1_000
'2_5':
  width: 0.01
l: -3
m: +4.5
n: .5
o: ""
p:
"""


def test_subset_and_scalar_resolution_match_pyyaml():
    yaml = pytest.importorskip("yaml")
    assert safe_load(SUBSET) == yaml.safe_load(SUBSET)


def test_reads_what_pyyaml_writes():
    yaml = pytest.importorskip("yaml")
    cfg = {"network": {"adjacency_matrix": [[0, 1], [1, 0]], "origin_nodes": [0]},
           "simulation": {"seed": None, "unit_time": 10, "path_finder": {"temp": 0.1}},
           "links": {}, "od_flows": {"0_1": [0.0, 1.5e-7, 2.0]},
           "strings": ["yes", "1e-5", "a: b", "#x"], "flag": True}
    assert safe_load(yaml.safe_dump(cfg, sort_keys=False)) == cfg


@pytest.mark.parametrize("text", ["a: |\n  x\n", "a: &x 1\n", "a:\n  b: 1\n   c: 2\n"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        safe_load(text)
