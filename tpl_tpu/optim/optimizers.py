"""
Ready-to-serve solver classes, mirroring the reference module surface.

The reference's ``tpl.optim.optimizers`` compiles its sympy configs to C
extension classes and injects them into this module's globals via
``build_optimizers()`` (reference: library/tpl/optim/optimizers.py:560-582),
after which drivers write ``opts.trajectory_tracking_mpc()``.

Here the "build" is instantaneous: each name binds a builder over the
native JAX problem definitions in :mod:`tpl_tpu.optim.problems`
(autodiff + jit replace codegen), returning a ready
:class:`tpl_tpu.optim.solver.Solver`. ``build_optimizers()`` is kept for
call-site compatibility and populates the globals the same way; the names
are also built lazily on first attribute access, so
``opts.trajectory_tracking_mpc()`` works without the explicit build call.

All seven configs are provided — including ``velocity_profile_time``,
which the reference defines but leaves out of its build list
(reference: optimizers.py:562-568).
"""

from tpl_tpu.optim import problems
from tpl_tpu.optim.solver import Solver

# (problem factory, horizon capacity). Solvers default to the host CPU
# backend: single-instance receding-horizon solves are latency-bound; use
# Solver/batched directly for batched solving on the accelerator.
_FACTORIES = {
    "trajectory_tracking_mpc": (problems.trajectory_tracking_mpc, 300),
    "trajectory_tracking_mpc_time": (problems.trajectory_tracking_mpc_time,
                                     300),
    "lateral_profile": (problems.lateral_profile, 300),
    "velocity_profile_space": (problems.velocity_profile_space, 300),
    "velocity_profile_time": (problems.velocity_profile_time, 300),
    "ref_line_smoother_k": (problems.ref_line_smoother_k, 300),
    "ref_line_smoother_dk": (problems.ref_line_smoother_dk, 300),
}


def _make_builder(name):
    factory, horizon_max = _FACTORIES[name]
    prob, spec = factory()

    def init_opt():
        return Solver(prob, spec, horizon_max=horizon_max, device="cpu")

    init_opt.__name__ = name
    init_opt.problem = prob
    init_opt.param_spec = spec
    return init_opt


def build_optimizers(force_rebuild=False):
    """Populate module globals with all solver builders
    (reference: optimizers.py:560-582)."""
    for name in _FACTORIES:
        if force_rebuild or name not in globals():
            globals()[name] = _make_builder(name)


def __getattr__(name):
    if name in _FACTORIES:
        builder = _make_builder(name)
        globals()[name] = builder
        return builder
    raise AttributeError(name)
