"""Lattice planner closed-loop tests (poly-lat sampling path + lon DP
with the time/deviation reinit replan policy)."""

import os

import numpy as np
import pytest

from tests.test_sim import _run_scenario

SLOW = os.environ.get("TPL_TPU_SLOW_TESTS", "") == "1"


def test_cv_3o_lattice_short():
    """Truncated parked_oncoming window: drive violation-free through the
    first replans (covers cold reinit, the 1 Hz warm reinit, and at least
    one full lat-sampling + lon-DP solve)."""
    ticks, _runtimes = _run_scenario(
        "demo/parked_oncoming", "lattice_planner", max_t=3.0)
    assert ticks >= 300


def test_lattice_ego_progresses():
    """The lattice planner must actually drive (zero violations alone
    would also hold for standing still)."""
    import uuid
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    sim = SimStandalone(app_id=uuid.uuid4().hex[:8],
                        scenario_path="demo/parked_oncoming")
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = "lattice_planner"
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
    v = []
    for _ in range(600):
        sim.update()
        with sim.core.sh_state.lock():
            v.append(sim.core.sh_state.sim.ego.v)
    assert np.max(v) > 3.0
    assert np.mean(v[300:]) > 2.0


@pytest.mark.skipif(not SLOW, reason="set TPL_TPU_SLOW_TESTS=1")
@pytest.mark.parametrize("scenario", [
    "demo/parked_oncoming",
    "demo/country_overtake",
])
def test_full_scenario_lattice(scenario):
    ticks, _runtimes = _run_scenario(scenario, "lattice_planner")
    assert ticks > 1000
