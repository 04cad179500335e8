"""Multi-chip scaling: device meshes and sharded batched environments.

The reference's only parallelism is process-level Ray rollout workers
(rl/train_ppo_rllib.py:62-64).  Here thousands of env replicas run as
ONE SPMD program: replicas vmap on-device and shard across devices via
``jax.sharding`` — XLA inserts the collectives.  Training gradients reduce with ``psum`` inside
``shard_map`` (see pednstream_tpu.rl.train for the full step).

Axes:
  ``env``  — environment replicas (data parallelism for rollouts and
             per-agent updates; the natural axis here since the policy
             nets are tiny and the simulation state dominates)
  ``link`` — the directed-link axis of a SINGLE replica's simulation
             state (parallel/link_shard.py): the TP analog for networks
             whose O(E*H) ring state exceeds one device's memory
"""

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "env") -> Mesh:
    """1-D device mesh over ``axis`` ('env' for replica DP; 'link' for
    simulation-state sharding via parallel/link_shard.py), over the first
    ``n_devices`` devices (all when None).  Raises when fewer exist."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(n_env: int, n_link: int,
                 axes: tuple = ("env", "link")) -> Mesh:
    """2-D mesh for the hybrid decomposition: replica DP on the first
    axis x link-state sharding on the second (parallel/link_shard.py
    hybrid_* helpers).

    The last-named axis varies fastest over the device list.  Four
    NVLink-connected H100s reach each other all to all at the same rate,
    so the placement of the axes on the cards does not matter: the mesh
    shape follows the algorithm alone (how many replica groups, how many
    link blocks).
    """
    devs = jax.devices()
    n = n_env * n_link
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]).reshape(n_env, n_link), axes)


def shard_batch(tree, mesh: Mesh, axis: str = "env"):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        if hasattr(x, "ndim") and x.ndim >= 1:
            return jax.device_put(x, sharding)
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, tree)


def data_parallel_env_step(core, mesh: Mesh, axis: str = "env"):
    """Compile a mesh-sharded batched env step.

    Returns step(states, actions) where every leaf's leading (batch) axis
    is sharded across ``mesh``; each chip steps its local shard of
    replicas, no cross-chip communication needed for pure rollouts.
    """
    batch_sh = NamedSharding(mesh, P(axis))

    @partial(
        jax.jit,
        in_shardings=(batch_sh, batch_sh),
        out_shardings=(batch_sh, batch_sh, batch_sh, batch_sh),
    )
    def step(states, actions):
        st, obs, rew, done, _ = jax.vmap(core._step_impl)(states, actions)
        return st, obs, rew, done

    return step
