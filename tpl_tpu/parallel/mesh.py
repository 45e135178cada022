"""
Device-mesh scale-out for batched scenario planning.

The reference has no distributed layer (single GPU + shared-memory
processes, SURVEY §2.4); this module is the new scale-out axis demanded by
the north star: scenario/obstacle-hypothesis batches are sharded over a
``jax.sharding.Mesh`` ("dp" axis), solvers run per-shard, and reductions
(best candidate cost, fleet statistics) are XLA collectives (NCCL
between GPUs) via ``shard_map``. Several hosts extend the same mesh with
``jax.distributed``.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Initialize multi-host jax.distributed when configured (no-op for
    single-host runs)."""
    if coordinator is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def scenario_mesh(n_devices=None, axis="dp"):
    """A 1-D device mesh over the scenario batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_scenarios(tree, mesh, axis="dp"):
    """Place a batched pytree with leading batch dim onto the mesh."""
    sharding = jax.sharding.NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


def sharded_best_candidate(batched_solve, mesh, axis="dp"):
    """Wrap a batched solve so the batch shards over the mesh and the
    globally best candidate cost is reduced across the mesh.

    batched_solve(batch_inputs...) -> (outputs, costs (B_local,))
    Returns solve(inputs...) -> (outputs, costs, global_best_cost).
    """

    def local(*args):
        out, costs = batched_solve(*args)
        best = jax.lax.pmin(jnp.min(costs), axis)
        return out, costs, best

    def wrapped(*args):
        in_specs = tuple(P(axis) for _ in args)
        fn = shard_map(local, mesh=mesh,
                       in_specs=in_specs,
                       out_specs=(P(axis), P(axis), P()),
                       check_vma=False)
        return jax.jit(fn)(*args)

    return wrapped
