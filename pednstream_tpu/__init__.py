"""pednstream_tpu — a JAX pedestrian Link Transmission Model framework.

A ground-up JAX/XLA rebuild of the capabilities of WaimenMak/PedNStream:
the per-timestep object-graph
``network_loading(t)`` loop becomes a pure ``step(state, t) -> state``
function over struct-of-arrays state, run with ``lax.scan`` over time and
``vmap`` over environment replicas, with ``jax.sharding`` across a
device mesh for batched rollouts and training.

Layer map (mirrors reference SURVEY.md §1):
  L1 core engine   : pednstream_tpu.engine / .fd / .state
  L2 routing/demand: pednstream_tpu.routing / .demand
  L3 scenario      : pednstream_tpu.config / .scenario / .topology
  L4 RL env        : pednstream_tpu.env
  L5 training      : pednstream_tpu.rl
  L6 service       : pednstream_tpu.mcp
  L0 io/viz        : pednstream_tpu.io / .viz
"""

__version__ = "0.1.0"

from .config import load_config, validate_config
from .scenario import Scenario, build_scenario
from .engine import make_step, simulate
from .state import NetworkState
from .network import Network

__all__ = [
    "load_config",
    "validate_config",
    "Scenario",
    "build_scenario",
    "make_step",
    "simulate",
    "NetworkState",
    "Network",
]
