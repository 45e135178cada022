"""
tpl_tpu — a JAX trajectory planning and MPC framework.

A from-scratch re-design of the capabilities of uulm-mrm/tpl
(reference snapshot 2025-04-18) as JAX/XLA programs:

- ``tpl_tpu.ops``         core math substrate (geometry, splines, profiles)
- ``tpl_tpu.optim``       batched augmented-Lagrangian iLQR solver core
                          (replaces the reference's sympy->C "genopt" pipeline,
                          reference: library/tpl/optim/genopt.py)
- ``tpl_tpu.environment`` environment model (maps, tracking, prediction)
- ``tpl_tpu.planning``    planners (RSTP, DP grid planners, sampling planners)
- ``tpl_tpu.control``     tracking controllers (MPC with dead-time compensation, ...)
- ``tpl_tpu.simulation``  closed-loop simulation, scenarios, rule checking
- ``tpl_tpu.application`` environment/planning/control application loops
- ``tpl_tpu.parallel``    device-mesh scale-out (shard_map over scenario batches)
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Enable 64-bit types: the host-pinned latency solvers (tracking MPC,
# RSTP stages) run in float64 like the reference's generated-C doubles —
# float32 command noise (~1e-2 in steering) destabilizes the zero-dead-
# time control loop at 100 Hz. Device kernels request float32
# explicitly throughout, so accelerator programs are unaffected. This is
# also the configuration the test suite runs under (tests/conftest.py).
_jax.config.update("jax_enable_x64", True)

# Full-precision float32 matmuls: on the GPU an f32 dot otherwise runs in
# TF32 (about three decimal digits), which the spline, iLQR and DP-lookup
# contractions cannot afford against their numpy oracles.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache: solver programs are compiled once per
# (problem, capacity, dtype) and reused across processes and runs.  JAX
# reads JAX_COMPILATION_CACHE_DIR itself; without it the cache sits at a
# fixed path inside the checkout (the path is part of the cache key).
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".cache", "jax")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
