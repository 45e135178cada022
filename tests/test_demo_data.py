"""
Vendored demo data: the framework must be fully usable standalone, from
its own data/ tree (maps, scenarios, param sets) — no reference checkout
required.  Mirrors the closed-loop acceptance gate of tests/test_sim.py
on the original demo scenarios.
"""

import os
import uuid

import numpy as np
import pytest

from tpl_tpu import util

SLOW = os.environ.get("TPL_TPU_SLOW_TESTS", "") == "1"

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def test_demo_data_vendored():
    """The repo ships its own data tree and resolution prefers it."""
    assert os.path.isdir(os.path.join(REPO_DATA, "maps", "demo"))
    assert util.resolve_data("maps", "demo") == os.path.join(
        REPO_DATA, "maps", "demo")
    assert util.resolve_data("scenarios", "demo/oval_lap") == os.path.join(
        REPO_DATA, "scenarios", "demo", "oval_lap")


def test_demo_map_store_loads():
    from tpl_tpu.environment.map_module import load_map_store

    maps = load_map_store("demo")
    md = util.get_obj_dict(maps)
    assert set(md) == {"oval", "country", "urban", "crossroad", "twolane",
                       "twolane_oncoming", "twolane_parking"}

    oval = md["oval"]
    assert oval.closed_path
    assert len(oval.path) > 400
    # discretized path: s monotonic at step_size, finite curvature
    assert np.all(np.isfinite(oval.path))
    steps = np.diff(oval.path[:, 3])
    assert np.allclose(steps, oval.step_size_discr, atol=0.01)

    urban = md["urban"]
    tags = [vl.__tag__ for vl in urban.velocity_limits]
    assert "traffic_light" in tags and "cross_walk" in tags
    assert len(urban.intersection_paths) == 1
    # the crossing segment resolved against the crossroad map
    ip = urban.intersection_paths[0]
    assert ip.map_segment is not None and ip.map_segment.path is not None
    assert len(ip.map_segment.path) > 10

    country = md["country"]
    assert country.velocity_limits[0].limit == 9.0


def _run_scenario(scenario, planner="path_vel_decomp_planner",
                  max_t=None, check_finished=False):
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id, scenario_path=scenario)

    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = planner
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.rule_checker.enable = True

    while True:
        sim.update()
        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            finished = s.finished
            sim_t = s.t
            violations = list(s.rule_checker.violations)
            ego = s.ego
        assert len(violations) == 0, (
            f"{scenario}/{planner} violated rules at t={sim_t}: "
            f"{violations[:3]}")
        if finished:
            break
        if max_t is not None and sim_t >= max_t:
            break
    if check_finished:
        assert finished, f"{scenario} did not finish by t={sim_t}"
    return sim_t, ego


def test_demo_follow_short():
    """Truncated closed-loop window on the country road (fast gate)."""
    t, ego = _run_scenario("demo/country_follow", max_t=4.0)
    assert ego.v > 4.0  # moving, following the leader


SCENARIOS = [
    ("demo/oval_lap", "path_vel_decomp_planner"),
    ("demo/country_follow", "path_vel_decomp_planner"),
    ("demo/country_overtake", "path_vel_decomp_planner"),
    ("demo/leader_brake", "path_vel_decomp_planner"),
    ("demo/urban_light", "path_vel_decomp_planner"),
    ("demo/urban_crossing", "path_vel_decomp_planner"),
    ("demo/country_follow", "dp_lat_lon_planner"),
    ("demo/country_overtake", "idm_sampling_planner"),
]


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
@pytest.mark.parametrize("scenario,planner", SCENARIOS)
def test_demo_scenario_full(scenario, planner):
    t, ego = _run_scenario(scenario, planner, check_finished=True)
    if scenario in ("demo/country_overtake", "demo/urban_light",
                    "demo/urban_crossing"):
        # these finish by passing a goal x, not by timeout
        assert ego.x > 100.0


def test_scenario_snapshot_resume(tmp_path):
    """Checkpoint/resume: freeze a running sim as a scenario and resume
    it exactly there (reference: state.py:316-337 — scenario state.json
    is a frozen SimState that resumes mid-scene)."""
    from tpl_tpu.simulation import SimStandalone
    from tpl_tpu.simulation.state import save_sim_state, load_sim_state

    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/country_follow")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    for _ in range(250):
        sim.update()

    with sim.core.sh_state.lock():
        frozen = sim.core.sh_state.sim
        t0, x0, v0 = frozen.t, frozen.ego.x, frozen.ego.v
        car_x0 = frozen.cars[0].x
        out = save_sim_state(frozen, str(tmp_path / "frozen"))
    assert t0 > 1.0 and v0 > 1.0

    resumed = load_sim_state(str(tmp_path / "frozen"))
    assert resumed.t == pytest.approx(t0)
    assert resumed.ego.x == pytest.approx(x0)
    assert resumed.ego.v == pytest.approx(v0)
    assert resumed.cars[0].x == pytest.approx(car_x0)
    assert resumed.finished is False

    # a fresh standalone resumes from the frozen scene and keeps driving
    sim2 = SimStandalone(app_id=uuid.uuid4().hex[:8],
                         scenario_path=str(tmp_path / "frozen"))
    with sim2.core.sh_state.lock():
        ss = sim2.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        assert ss.ego.x == pytest.approx(x0)
    for _ in range(50):
        sim2.update()
    with sim2.core.sh_state.lock():
        s2 = sim2.core.sh_state.sim
        # reference parity: the scene resumes but the clock restarts
        # (reference core.py:68 resets sim.t = 0.0 on reload)
        assert 0.0 < s2.t < t0
        assert s2.ego.x > x0 + 0.5  # still driving from the frozen pose


@pytest.mark.parametrize("ego_x,t,oncoming_x,finished", [
    (114.9, 45.0, (0.0, 0.0), False),    # stalled behind the parked car
    (160.0, 20.0, (100.0, 120.0), False),  # not past the parked car
    (224.0, 20.0, (100.0, 230.0), False),  # an oncoming car not met yet
    (224.0, 19.0, (100.0, 180.0), False),  # before the 20 s mark
    (224.0, 20.0, (100.0, 180.0), True),
])
def test_parked_oncoming_finishes_only_past_the_cars(ego_x, t, oncoming_x,
                                                     finished):
    """demo/parked_oncoming has no timeout: a stalled ego never finishes,
    so every closed-loop gate on it catches a stall."""
    from tpl_tpu.simulation.state import load_sim_state

    sim = load_sim_state("demo/parked_oncoming")
    assert sim.init_planning_params == "parked_oncoming"
    sim.ego.x, sim.t = ego_x, t
    for car, x in zip([c for c in sim.cars if c.reverse], oncoming_x):
        car.x = x
    sim.manager.update(sim)
    assert bool(sim.finished) == finished
