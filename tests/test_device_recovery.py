"""Planning app recovery from device failures (JaxRuntimeError)."""

import numpy as np
import jax

from tpl_tpu.simulation import SimStandalone


def test_planner_device_failure_latches_emergency_and_rebuilds():
    sim = SimStandalone(app_id="devrec", scenario_path="default")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    app = sim.planning_app
    name = app.sh_planners.active_planner
    planner = app.planners[name]

    sim.update()

    calls = {"n": 0}

    def boom(env):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("INTERNAL: device failure")

    planner.update = boom
    sim.update()

    assert calls["n"] == 1
    # emergency trajectory published
    with app.sh_planners.lock():
        assert app.sh_planners.trajectory.emergency
    # planner instance was rebuilt (fresh object, no poisoned state)
    assert app.planners[name] is not planner
    assert type(app.planners[name]) is type(planner)

    # next tick plans normally again with the fresh instance
    sim.update()
    with app.sh_planners.lock():
        assert not app.sh_planners.trajectory.emergency
