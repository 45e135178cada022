"""Planner x controller compatibility smoke matrix.

Mirrors the reference's test_params.py: instantiate the full standalone
sim and run one tick with every planner x controller combination.
"""

import uuid

import numpy as np


def test_every_planner_with_every_controller():
    np.random.seed(0)
    from tpl_tpu.simulation import SimStandalone

    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/parked_oncoming")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    planners = list(sim.planning_app.planners.keys())
    controllers = list(sim.control_app.controllers.keys())
    assert "path_vel_decomp_planner" in planners
    assert "dp_lat_lon_planner" in planners
    assert "poly_lat_dp_lon_planner" in planners
    assert "idm_sampling_planner" in planners
    assert "poly_sampling_planner" in planners
    assert "model_predictive_controller" in controllers
    assert "model_predictive_controller_time" in controllers
    assert "feedforward_controller" in controllers
    assert "flat_controller" in controllers
    assert "const_acc_controller" in controllers
    assert "direct_controller" in controllers

    for p in planners:
        for c in controllers:
            with sim.planning_app.sh_planners.lock():
                sim.planning_app.sh_planners.active_planner = p
            with sim.control_app.sh_controllers.lock():
                sim.control_app.sh_controllers.active_controller = c
            sim.update()   # must not raise
