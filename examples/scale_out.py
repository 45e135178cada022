"""
Scale-out demo: batched MPC tracking solves sharded over a device mesh.

The reference is single-GPU (SURVEY §2.4); this framework adds the
scale-out axis: a scenario batch shards over a 1-D ``jax.sharding.Mesh``
("dp"), every device runs the full AL-iLQR tracking solve on its shard,
and the globally best candidate cost reduces across devices (``lax.pmin``
inside ``shard_map``).  On real hardware the same code spans the GPUs
of a host (and several hosts via ``jax.distributed`` —
``tpl_tpu.parallel.init_distributed``); here it runs on however many
devices are available, e.g. a virtual CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
      python examples/scale_out.py

Prints per-configuration wall time and the scaling curve (virtual CPU
devices share host cores, so virtual-mesh "efficiency" only validates
correct sharding, not speedup — real scaling needs real cards).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from tpl_tpu.parallel import scenario_mesh, shard_scenarios, \
    sharded_best_candidate


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    update, state, x0, params, cfg = ge._mpc_setup(horizon=60,
                                                   max_iterations=6)
    per_dev = 64

    def batched_solve(bx0):
        bstate = jax.tree.map(
            lambda a: jnp.broadcast_to(a, bx0.shape[:1] + a.shape), state)
        out, info = jax.vmap(update, in_axes=(0, 0, None, None))(
            bstate, bx0, params, cfg)
        return out.u[:, 0], info["traj_costs"]

    results = []
    for n in [d for d in (1, 2, 4, 8) if d <= n_dev]:
        B = per_dev * n
        mesh = scenario_mesh(n)
        solve = sharded_best_candidate(batched_solve, mesh)
        bx0 = (jnp.broadcast_to(x0, (B,) + x0.shape)
               + 0.01 * jnp.arange(B, dtype=x0.dtype)[:, None])
        bx0 = shard_scenarios(bx0, mesh)

        u0, costs, best = solve(bx0)          # compile
        jax.block_until_ready(u0)
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            u0, costs, best = solve(bx0)
        jax.block_until_ready(u0)
        dt = (time.perf_counter() - t0) / iters
        rate = B / dt
        results.append((n, B, dt * 1e3, rate, float(best)))
        print(f"mesh={n}d  batch={B:4d}  {dt*1e3:7.1f} ms/step  "
              f"{rate:8.0f} solves/s  best_cost={float(best):.3f}")

    if len(results) > 1:
        base = results[0][3]
        print("\nscaling (weak, batch grows with devices):")
        for n, B, ms, rate, _ in results:
            eff = rate / (base * n)
            print(f"  {n} devices: {rate/base:5.2f}x  efficiency {eff:5.1%}")


if __name__ == "__main__":
    main()
