from tpl_tpu.optim.ilqr import (
    EULER, HEUN, RK4,
    Problem,
    SolverState,
    make_update_fn,
    init_state,
)
from tpl_tpu.optim.solver import Solver, ArraySpec
from tpl_tpu.optim import problems
from tpl_tpu.optim.problems import (
    lateral_profile,
    velocity_profile_space,
    velocity_profile_time,
    ref_line_smoother_k,
    ref_line_smoother_dk,
    trajectory_tracking_mpc,
    trajectory_tracking_mpc_time,
)

# The genopt-compatible sympy frontend (symext, genopt, optimizers) is
# imported on use only, `from tpl_tpu.optim import genopt`, so the main
# path needs no sympy.
