"""What the GPU entry points do on a machine without a GPU, the compile
cache location, and the main path's independence from flax, PyYAML and
NetworkX.  The GPU phases themselves run in chip_smoke.py on the card."""

import json
import os
import subprocess
import sys
import types

import pytest

import jax

from pednstream_tpu.utils import gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _card(platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_gpu_guard_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="no GPU found"):
        gpu.require_gpu(jax.devices())
    gpu.require_gpu([_card()])  # a GPU passes


def test_chip_smoke_last_line_format():
    import chip_smoke

    line = chip_smoke.result_line([_card()] * 4)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(line)["device"]["count"] == 4


@pytest.mark.parametrize("entry", ["chip_smoke", "bench"])
def test_entry_points_exit_nonzero_without_gpu(entry, capsys):
    module = __import__(entry)
    with pytest.raises(SystemExit) as exc:
        module.main([]) if entry == "chip_smoke" else module.main()
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert gpu.configure_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert gpu.configure_compile_cache() == os.path.join(ROOT, ".jax_cache")
    path = gpu.configure_compile_cache(tmp_path)
    assert path == str(tmp_path / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", os.path.join(ROOT, ".jax_cache")),
                     ("jax_compilation_cache_dir", path)]


_NO_OPTIONAL_PACKAGES = """
import sys
for name in ("flax", "yaml", "networkx"):
    sys.modules[name] = None
import jax
jax.config.update("jax_platforms", "cpu")
import pednstream_tpu
from pednstream_tpu.engine import simulate
from pednstream_tpu.env import PedNetEnvCore, build_agent_spec
from pednstream_tpu.generator import NetworkEnvGenerator
from pednstream_tpu.mcp import server

scn = NetworkEnvGenerator().create_network("melbourne")
final, _ = simulate(scn, scn.engine_params, scn.init_state(jax.random.PRNGKey(0)),
                    5, stochastic=True, record=False)
assert int(final.t) == 6
env_scn = NetworkEnvGenerator().create_network("butterfly_scC")
core = PedNetEnvCore(env_scn, build_agent_spec(env_scn))
states, obs = core.batch_reset(jax.random.split(jax.random.PRNGKey(1), 2))
sim = server.create_environment("small_network")
assert "error" not in sim, sim
assert server.run_simulation(sim["sim_id"], steps=3)["current_step"] == 3
print("main path ok")
"""


def test_main_path_runs_without_flax_yaml_networkx():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _NO_OPTIONAL_PACKAGES], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "main path ok" in r.stdout
