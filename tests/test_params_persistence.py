"""Parameter-set save/load round trip (objtoolbox-compatible layout)."""

import uuid
import contextlib

import numpy as np


def test_planning_params_roundtrip(tmp_path, monkeypatch):
    np.random.seed(0)
    from tpl_tpu import util
    from tpl_tpu.application.planning_app import (
        PlanningApp, load_planning_params, save_planning_params)

    # param paths resolve through util.PATH_PARAMS at call time
    monkeypatch.setattr(util, "PATH_PARAMS", str(tmp_path))

    from tpl_tpu.application.environment_app import EnvironmentApp
    env_app = EnvironmentApp(uuid.uuid4().hex[:8])
    app = PlanningApp(env_app.app_id, shared_env=env_app.env)
    sh = app.sh_planners

    with sh.lock():
        sh.active_planner = "idm_sampling_planner"
        sh.path_vel_decomp_planner.params.horizon = 123
        sh.path_vel_decomp_planner.params.velocity_optim.dt_safe = 2.25
        sh.storage = "roundtrip"
        save_planning_params(sh)

    # mutate, then load back
    with sh.lock():
        sh.active_planner = "base_planner" \
            if hasattr(sh, "base_planner") else sh.planner_names[0]
        sh.path_vel_decomp_planner.params.horizon = 1
        sh.path_vel_decomp_planner.params.velocity_optim.dt_safe = 0.1
        load_planning_params(sh, "roundtrip")

        assert sh.active_planner == "idm_sampling_planner"
        assert sh.path_vel_decomp_planner.params.horizon == 123
        assert (sh.path_vel_decomp_planner.params.velocity_optim.dt_safe
                == 2.25)


def test_load_reference_param_sets():
    """The vendored "demo" param sets (objtoolbox state.json format, the
    reference's own layout) load into the app registries."""
    np.random.seed(0)
    import uuid as _uuid
    from tpl_tpu.application.planning_app import (
        PlanningApp, load_planning_params)
    from tpl_tpu.application.control_app import (
        ControlApp, load_control_params)

    from tpl_tpu.application.environment_app import EnvironmentApp
    env_app = EnvironmentApp(_uuid.uuid4().hex[:8])
    app = PlanningApp(env_app.app_id, shared_env=env_app.env)
    with app.sh_planners.lock():
        load_planning_params(app.sh_planners, "demo")
        assert app.sh_planners.active_planner == "path_vel_decomp_planner"

    capp = ControlApp(_uuid.uuid4().hex[:8])
    with capp.sh_controllers.lock():
        load_control_params(capp.sh_controllers, "demo")
        assert (capp.sh_controllers.active_controller
                == "model_predictive_controller")
        mpc = capp.sh_controllers.model_predictive_controller.params
        assert mpc.cost_function.p_phi == 1000.0
