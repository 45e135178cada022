"""
Closed-loop scenario integration tests: full SimStandalone, deterministic
fixed-step, zero rule violations as the acceptance gate.

Mirrors the reference's test strategy (library/test/test_sim.py:17-51:
scenario x planner matrix, rule checker assertions, runtime logging).
The full-length scenario runs are gated behind TPL_TPU_SLOW_TESTS=1; the
default suite runs a truncated window of the first scenario.
"""

import os
import uuid

import numpy as np
import pytest


SLOW = os.environ.get("TPL_TPU_SLOW_TESTS", "") == "1"


def _run_scenario(scenario, planner, max_t=None, max_ticks=None):
    from tpl_tpu.simulation import SimStandalone
    from tpl_tpu.util import StoreRegistry

    np.random.seed(0)
    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id, scenario_path=scenario)

    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = planner

    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.settings.reload_if_finished = False
        ss.rule_checker.enable = True

    ticks = 0
    runtimes = []
    while True:
        sim.update()
        ticks += 1
        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            finished = s.finished
            sim_t = s.t
            violations = list(s.rule_checker.violations)
        # the acceptance gate: zero violations after every tick
        assert len(violations) == 0, (
            f"{scenario}/{planner} violated rules at t={sim_t}: "
            f"{violations[:3]}")
        with sim.planning_app.sh_planners.lock():
            runtimes.append(sim.planning_app.sh_planners.runtime)
        if finished:
            break
        if max_t is not None and sim_t >= max_t:
            break
        if max_ticks is not None and ticks >= max_ticks:
            break

    return ticks, np.array(runtimes)


@pytest.mark.parametrize("planner", [
    "path_vel_decomp_planner",
    "dp_lat_lon_planner",
    "poly_lat_dp_lon_planner",
    "dp_poly_planner",
    "lattice_planner",
    "idm_sampling_planner",
    "poly_sampling_planner",
])
def test_full_cv_3o_every_planner_family(planner):
    """DEFAULT-GATE closed-loop coverage: every planner family drives the
    full demo/parked_oncoming scene (parked car + oncoming traffic, the
    shape of the reference's acc_2024/cv_3o) to its
    manager-set finish with zero rule violations.  The wider scenario x
    planner matrix stays behind TPL_TPU_SLOW_TESTS."""
    # safety cap: a planner that stalls the ego must fail, not hang CI
    ticks, runtimes = _run_scenario("demo/parked_oncoming", planner,
                                    max_t=120.0)
    assert ticks > 1000
    assert ticks < 11900, f"{planner} never finished the scene"


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
@pytest.mark.parametrize("scenario", [
    "demo/parked_oncoming",
    "demo/country_overtake",
    "demo/leader_brake",
])
def test_full_scenario_rstp(scenario):
    ticks, runtimes = _run_scenario(scenario, "path_vel_decomp_planner")
    assert ticks > 1000


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
@pytest.mark.parametrize("scenario", [
    "demo/parked_oncoming",
    "demo/country_overtake",
    "demo/leader_brake",
])
def test_full_scenario_dp_lat_lon(scenario):
    """Full scenario matrix with the DP grid planner (reference:
    library/test/test_sim.py runs both planners over all 3 scenarios)."""
    ticks, runtimes = _run_scenario(scenario, "dp_lat_lon_planner")
    assert ticks > 1000


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
def test_full_scenario_idm_sampling():
    """Full parked_oncoming with the IDM sampling planner: finish the
    scene violation-free."""
    ticks, runtimes = _run_scenario("demo/parked_oncoming",
                                    "idm_sampling_planner")
    assert ticks > 1000


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
def test_full_scenario_poly_sampling():
    """Full parked_oncoming with the Werling-style Frenet poly sampling
    planner: finish the scene violation-free."""
    ticks, runtimes = _run_scenario("demo/parked_oncoming",
                                    "poly_sampling_planner")
    assert ticks > 1000


def test_bad_scenario_hard_fails():
    """A misnamed scenario must raise before the first tick, not
    silently run whatever scene happens to be in the store (which would
    let a sweep/CI typo record garbage rule violations)."""
    from tpl_tpu.simulation import ScenarioLoadError, SimStandalone

    app_id = uuid.uuid4().hex[:8]
    with pytest.raises(ScenarioLoadError, match="no_such_scenario"):
        SimStandalone(app_id=app_id,
                      scenario_path="typo_group/no_such_scenario")


@pytest.mark.xfail(strict=True, reason=(
    "known environment-caused fail: under seed 0 a randomized merge car "
    "(manager.py np.random) rear-ends the yielding ego at ~19 m/s with a "
    "gap its own IDM brake cap (b=3) cannot absorb (required ~4.4 m/s^2 "
    "from first sight); rear tracks are dropped by "
    "the prediction module (reference parity: "
    "prediction_module.py:137-169), so no planner in either framework "
    "sees it coming"))
def test_jungingen_right_seed0_known_fail():
    """Pins the documented jungingen_right seed-0 collision so the
    known-fail stays reproducible and any behavior change (fixed OR
    newly broken) surfaces as a test-state change."""
    _run_scenario("fas_2025/jungingen_right", "path_vel_decomp_planner",
                  max_t=35.0)


@pytest.mark.xfail(strict=True, reason=(
    "known scenario-data fail: the saved ego pose starts 2.057 m left "
    "of the path where the map's own control polygon promises "
    "d_left = 2.0 m, so the rule checker flags OFF_ROAD at t=0 before "
    "any planner acts; the reference flags the identical violation — "
    "its per-scenario off_road_dist_limit tolerance is dead code "
    "upstream (defined reference:library/tpl/simulation/state.py:215, "
    "never read; the checker compares against raw d_left, "
    "reference:library/tpl/simulation/core.py:351-364)"))
def test_intersection_loop_off_road_known_fail():
    """Pins the documented test/intersection_loop OFF_ROAD spawn defect
    (the second VIOL row of the full scenario sweep) so the known-fail
    stays reproducible like jungingen_right."""
    _run_scenario("test/intersection_loop", "path_vel_decomp_planner",
                  max_t=2.0)


def test_unknown_active_planner_latches_emergency():
    """An unknown active-planner selector must not leave the stale
    trajectory in the store (the vehicle would silently keep tracking
    it and drift off the road): the planning app publishes an
    emergency trajectory — routed to ConstAccController, the same
    degrade path used on device loss — until a valid name is set."""
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id,
                        scenario_path="demo/leader_brake")
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = "no_such_planner"
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    for _ in range(3):
        sim.update()
    with sim.planning_app.sh_planners.lock():
        assert sim.planning_app.sh_planners.trajectory.emergency
    # selecting a real planner recovers: a fresh plan replaces the latch
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = \
            "path_vel_decomp_planner"
    for _ in range(20):
        sim.update()
        with sim.planning_app.sh_planners.lock():
            if not sim.planning_app.sh_planners.trajectory.emergency:
                break
    with sim.planning_app.sh_planners.lock():
        assert not sim.planning_app.sh_planners.trajectory.emergency
