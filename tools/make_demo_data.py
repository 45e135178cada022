"""
Generate the vendored demo data set (maps, scenarios, param sets) into
``<repo>/data``, so the framework is fully usable standalone.

All content here is original: a stadium test track, a winding country
road, and an urban street with a traffic light, a crosswalk and a
crossing road — plus closed-loop scenarios on them.  The on-disk format
is the objtoolbox-compatible ``state.json`` (+ extern npy) layout that
:mod:`tpl_tpu.util` reads, so the same loaders also accept a user's
existing tpl data directory via ``TPL_TPU_DATA``.

Run:  python tools/make_demo_data.py [--params]
(--params additionally regenerates the "demo" param sets, which needs
the planner/controller stacks importable.)
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpl_tpu import util
from tpl_tpu.environment.map_module import (
    Map, VelocityLimit, TrafficLight, CrossWalk, IntersectionPath,
    TurnIndPoint, reinit_map,
)
from tpl_tpu.simulation.state import (
    SimState, SimCar, SimTrafficLight, SimTimeConstraint,
)

REPO_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "data")


def _stable_uuid(name):
    """Deterministic ids keep the generated data diff-stable."""
    import hashlib
    return hashlib.sha1(("tpl-tpu-demo:" + name).encode()).hexdigest()[:32]


# --------------------------------------------------------------------------
# maps


def make_oval():
    """Closed stadium track: two 110 m straights + 35 m radius turns."""
    m = Map("oval")
    m.uuid = _stable_uuid("map-oval")
    m.closed_path = True
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    L, R = 110.0, 35.0
    pts = []
    # bottom straight (left to right)
    for x in np.arange(0.0, L, 5.0):
        pts.append((x, 0.0))
    # right turn (half circle)
    for a in np.arange(-90.0, 90.0, 7.5):
        r = np.radians(a)
        pts.append((L + R * np.cos(r), R + R * np.sin(r)))
    # top straight (right to left)
    for x in np.arange(L, 0.0, -5.0):
        pts.append((x, 2 * R))
    # left turn
    for a in np.arange(90.0, 270.0, 7.5):
        r = np.radians(a)
        pts.append((R * np.cos(r), R + R * np.sin(r)))

    cps = np.zeros((len(pts), 6))
    cps[:, :2] = pts
    cps[:, 2] = 3.2     # d_left
    cps[:, 3] = 3.2     # d_right
    cps[:, 4] = 13.0    # speed limit
    m.control_points = cps
    return m


def make_country():
    """Open 700 m winding country road with a slow zone."""
    m = Map("country")
    m.uuid = _stable_uuid("map-country")
    m.closed_path = False
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    xs = np.arange(0.0, 700.0 + 1e-9, 10.0)
    ys = 20.0 * np.sin(xs / 70.0) + 7.0 * np.sin(xs / 33.0 + 1.3)
    cps = np.zeros((len(xs), 6))
    cps[:, 0] = xs
    cps[:, 1] = ys
    cps[:, 2] = 3.0
    cps[:, 3] = 3.0
    cps[:, 4] = 16.0
    # narrowing section
    narrow = (xs > 380.0) & (xs < 470.0)
    cps[narrow, 2] = 2.4
    cps[narrow, 3] = 2.4
    m.control_points = cps
    reinit_map(m)

    # a 9 m/s zone through the narrow section, placed on the path
    vl = VelocityLimit()
    vl.uuid = _stable_uuid("country-vl-narrow")
    proj = util.project(m.path[:, :2], np.array([400.0, np.interp(
        400.0, xs, ys)]))
    vl.pos = np.array(proj.point)
    vl.limit = 9.0
    vl.length = 90.0
    m.velocity_limits = [vl]
    return m


def _twolane_centerline():
    xs = np.arange(0.0, 500.0 + 1e-9, 10.0)
    ys = 10.0 * np.sin(xs / 80.0)
    return xs, ys


def make_twolane():
    """Two-lane rural road, 500 m.  The path is the right (ego) lane's
    center; ``d_left`` spans the oncoming lane too, so an overtake stays
    on the road."""
    m = Map("twolane")
    m.uuid = _stable_uuid("map-twolane")
    m.closed_path = False
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    xs, ys = _twolane_centerline()
    cps = np.zeros((len(xs), 6))
    cps[:, 0] = xs
    cps[:, 1] = ys
    cps[:, 2] = 5.5     # d_left: own half lane + the oncoming lane
    cps[:, 3] = 2.0     # d_right: lane edge
    cps[:, 4] = 12.0
    m.control_points = cps
    return m


def make_parallel_lane(ego_lane, name, offset):
    """A path ``offset`` m left of ``ego_lane``'s path (negative: right),
    in the same direction.  Traffic on the oncoming lane (offset 3.5)
    drives with ``reverse``; a parking strip (offset -2.5) holds a car
    half on the shoulder, reaching 0.5 m into the ego lane."""
    m = Map(name)
    m.uuid = _stable_uuid("map-" + name)
    m.closed_path = False
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    reinit_map(ego_lane)
    p = ego_lane.path[::20]
    n = np.stack([-np.sin(p[:, 2]), np.cos(p[:, 2])], axis=1)
    cps = np.zeros((len(p), 6))
    cps[:, :2] = p[:, :2] + offset * n
    cps[:, 2] = 2.0
    cps[:, 3] = 2.0
    cps[:, 4] = 12.0
    m.control_points = cps
    return m


def _urban_centerline():
    xs = np.arange(0.0, 450.0 + 1e-9, 5.0)
    ys = 8.0 * (1.0 - np.cos(xs / 90.0))
    return xs, ys


def make_urban():
    """Urban street: traffic light, crosswalk, crossing side road."""
    m = Map("urban")
    m.uuid = _stable_uuid("map-urban")
    m.closed_path = False
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    xs, ys = _urban_centerline()
    cps = np.zeros((len(xs), 6))
    cps[:, 0] = xs
    cps[:, 1] = ys
    cps[:, 2] = 3.0
    cps[:, 3] = 3.0
    cps[:, 4] = 8.5
    m.control_points = cps
    reinit_map(m)

    def at_arc(s):
        i = int(np.argmin(np.abs(m.path[:, 3] - s)))
        return m.path[i]

    # traffic light at s = 160 (light mast 2.5 m right of the lane)
    p = at_arc(160.0)
    tl = TrafficLight()
    tl.uuid = _stable_uuid("urban-tl")
    tl.pos = p[:2].copy()
    n = np.array([np.cos(p[2] + np.pi / 2), np.sin(p[2] + np.pi / 2)])
    tl.light_pos = p[:2] - 2.5 * n
    tl.detection_radius = 4.0
    tl.length = 25.0
    m.velocity_limits = [tl]

    # crosswalk at s = 260
    p = at_arc(260.0)
    cw = CrossWalk()
    cw.uuid = _stable_uuid("urban-cw")
    cw.pos = p[:2].copy()
    t = np.array([np.cos(p[2]), np.sin(p[2])])
    n = np.array([np.cos(p[2] + np.pi / 2), np.sin(p[2] + np.pi / 2)])
    cw.corners = np.stack([
        p[:2] - 2.0 * t - 4.0 * n, p[:2] + 2.0 * t - 4.0 * n,
        p[:2] + 2.0 * t + 4.0 * n, p[:2] - 2.0 * t + 4.0 * n])
    cw.free_limit = 8.5
    m.velocity_limits.append(cw)

    # intersection with the crossing road at s = 330
    p = at_arc(330.0)
    ip = IntersectionPath(pos=p[:2].copy())
    ip.uuid = _stable_uuid("urban-ip")
    ip.stop_pos = at_arc(322.0)[:2].copy()
    ip.intersection_map_uuid = "crossroad"   # store key of the side road
    ip.offset_path_begin = -25
    ip.offset_path_end = 25
    ip.d_decision = 40.0
    ip.gap_acceptance = 5.0
    ip.gap_rejection = 3.0
    m.intersection_paths = [ip]
    return m, p


def make_crossroad(cross_pt):
    """Straight side road crossing the urban street perpendicularly."""
    m = Map("crossroad")
    m.uuid = _stable_uuid("map-crossroad")
    m.closed_path = False
    m.smoothing = 0.0
    m.step_size_discr = 0.5

    ang = cross_pt[2] + np.pi / 2
    d = np.array([np.cos(ang), np.sin(ang)])
    ss = np.arange(-90.0, 90.0 + 1e-9, 5.0)
    cps = np.zeros((len(ss), 6))
    cps[:, 0] = cross_pt[0] + ss * d[0]
    cps[:, 1] = cross_pt[1] + ss * d[1]
    cps[:, 2] = 3.0
    cps[:, 3] = 3.0
    cps[:, 4] = 8.5
    m.control_points = cps
    return m


def write_maps():
    oval = make_oval()
    country = make_country()
    urban, cross_pt = make_urban()
    crossroad = make_crossroad(cross_pt)
    twolane = make_twolane()

    maps = {"oval": oval, "country": country, "urban": urban,
            "crossroad": crossroad, "twolane": twolane,
            "twolane_oncoming": make_parallel_lane(
                twolane, "twolane_oncoming", 3.5),
            "twolane_parking": make_parallel_lane(
                twolane, "twolane_parking", -2.5)}
    out = os.path.join(REPO_DATA, "maps", "demo")
    util.save_state_dict(util.Bundle(**maps), out)
    print("wrote", out)
    return maps


# --------------------------------------------------------------------------
# scenarios


def _base_state(maps, map_name, s_ego, v_ego=0.0):
    cmap = maps[map_name]
    if cmap.path is None:
        reinit_map(cmap)
    i = int(np.argmin(np.abs(cmap.path[:, 3] - s_ego)))
    p = cmap.path[i]

    sim = SimState()
    sim.map_store_path = "demo"
    sim.selected_map = map_name
    sim.init_env_params = "demo"
    sim.init_planning_params = "demo"
    sim.init_control_params = "demo"
    sim.ego.x = float(p[0])
    sim.ego.y = float(p[1])
    sim.ego.yaw = float(p[2])
    sim.ego.v = float(v_ego)
    sim.rule_checker.enable = False
    sim.settings.running = False
    sim.settings.use_real_time = True
    return sim


def _car(maps, map_name, s, v, target_v=None, use_idm=True, evade="",
         reverse=False):
    cmap = maps[map_name]
    if cmap.path is None:
        reinit_map(cmap)
    i = int(np.argmin(np.abs(cmap.path[:, 3] - s)))
    p = cmap.path[i]
    c = SimCar()
    c.uuid = _stable_uuid(f"car-{map_name}-{s:.0f}")
    c.map_uuid = map_name
    c.reverse = reverse
    c.x = float(p[0])
    c.y = float(p[1])
    c.yaw = float(p[2] + np.pi if reverse else p[2])
    c.v = float(v)
    c.target_v = float(v if target_v is None else target_v)
    c.use_idm = use_idm
    c.evade = evade
    return c


def _savestate_sim(sim):
    d = sim.__dict__.copy()
    d.pop("manager", None)
    d.pop("available_maps", None)
    return d


def _write_scenario(name, sim, manager_src=None):
    out = os.path.join(REPO_DATA, "scenarios", name)
    util.save_state_dict(_savestate_sim(sim), out)
    if manager_src is not None:
        with open(os.path.join(out, "manager.py"), "w") as f:
            f.write(manager_src)
    print("wrote", out)


MANAGER_TIMEOUT = """\
class SimulationManager:
    \"\"\"Finish the scenario after {timeout} simulated seconds.\"\"\"

    def __init__(self, sim):
        pass

    def update(self, sim):
        if sim.t > {timeout}:
            sim.finished = True
"""

MANAGER_PASS_X = """\
class SimulationManager:
    \"\"\"Finish once the ego passes x = {x_done} (or after {timeout} s).\"\"\"

    def __init__(self, sim):
        pass

    def update(self, sim):
        if sim.ego.x > {x_done} or sim.t > {timeout}:
            sim.finished = True
"""

MANAGER_PASS_ONCOMING = """\
class SimulationManager:
    \"\"\"Finish at t >= {t_min} s once the ego is past x = {x_done} (the
    parked car and a margin) and has met every oncoming car.  There is
    no timeout: an ego that stalls never finishes, and the caller's own
    time cap counts that as a failure.\"\"\"

    def __init__(self, sim):
        pass

    def update(self, sim):
        ego = sim.ego
        passed = ego.x > {x_done} and all(
            c.x < ego.x for c in sim.cars if c.reverse)
        if sim.t >= {t_min} and passed:
            sim.finished = True
"""

MANAGER_LIGHT = """\
class SimulationManager:
    \"\"\"Red light until t = {t_green}, then green; finish past the
    intersection or after {timeout} s.\"\"\"

    RED = 0
    GREEN = 2

    def __init__(self, sim):
        pass

    def update(self, sim):
        for tl in sim.traffic_lights:
            tl.state = self.RED if sim.t < {t_green} else self.GREEN
        if sim.ego.x > {x_done} or sim.t > {timeout}:
            sim.finished = True
"""

MANAGER_BRAKE = """\
class SimulationManager:
    \"\"\"Leader braking cycle: drives at 8 m/s, brakes to a stop at
    t = 10 s, reaccelerates at t = 22 s.  Finish after {timeout} s.\"\"\"

    def __init__(self, sim):
        pass

    def update(self, sim):
        if not sim.cars:
            return
        lead = sim.cars[0]
        if sim.t < 10.0:
            lead.target_v = 8.0
        elif sim.t < 22.0:
            lead.target_v = 0.0
        else:
            lead.target_v = 8.0
        if sim.t > {timeout}:
            sim.finished = True
"""


def write_scenarios(maps):
    # default: country road, one slower car ahead, not auto-running
    sim = _base_state(maps, "country", s_ego=15.0, v_ego=0.0)
    sim.cars = [_car(maps, "country", s=80.0, v=8.0)]
    _write_scenario("default", sim)

    # oval_lap: empty closed track, one flying lap
    sim = _base_state(maps, "oval", s_ego=5.0, v_ego=0.0)
    _write_scenario("demo/oval_lap", sim,
                    MANAGER_TIMEOUT.format(timeout=45.0))

    # country_follow: two IDM cars ahead
    sim = _base_state(maps, "country", s_ego=15.0, v_ego=8.0)
    sim.cars = [
        _car(maps, "country", s=60.0, v=7.0),
        _car(maps, "country", s=170.0, v=10.0),
    ]
    _write_scenario("demo/country_follow", sim,
                    MANAGER_TIMEOUT.format(timeout=40.0))

    # country_overtake: stationary vehicle in the lane, evade left
    sim = _base_state(maps, "country", s_ego=20.0, v_ego=9.0)
    blocker = _car(maps, "country", s=140.0, v=0.0, use_idm=False,
                   evade="left")
    blocker.target_v = 0.0
    sim.cars = [blocker]
    x_done = float(blocker.x + 45.0)
    _write_scenario("demo/country_overtake", sim,
                    MANAGER_PASS_X.format(x_done=x_done, timeout=45.0))

    # leader_brake: adversarial braking leader
    sim = _base_state(maps, "country", s_ego=15.0, v_ego=8.0)
    sim.cars = [_car(maps, "country", s=55.0, v=8.0)]
    _write_scenario("demo/leader_brake", sim,
                    MANAGER_BRAKE.format(timeout=38.0))

    # parked_oncoming: a car parked half on the shoulder, reaching into
    # the ego lane, and two oncoming cars that meet the ego just past it
    # (three objects); 20 s of driving, finished only if the ego got past
    # both.  Its planning param set is its own (see write_scene_params).
    sim = _base_state(maps, "twolane", s_ego=15.0, v_ego=8.0)
    sim.init_planning_params = SCENE_PLANNING_PARAMS
    parked = _car(maps, "twolane_parking", s=130.0, v=0.0, use_idm=False,
                  evade="left")
    sim.cars = [parked] + [
        _car(maps, "twolane_oncoming", s=s, v=10.0, use_idm=False,
             reverse=True) for s in (300.0, 380.0)]
    _write_scenario("demo/parked_oncoming", sim,
                    MANAGER_PASS_ONCOMING.format(
                        t_min=20.0, x_done=float(parked.x + 45.0)))

    # urban_light: red light turns green at t = 10
    urban = maps["urban"]
    tl_item = urban.velocity_limits[0]
    sim = _base_state(maps, "urban", s_ego=10.0, v_ego=6.0)
    stl = SimTrafficLight()
    stl.uuid = _stable_uuid("sim-tl-urban")
    stl.x = float(tl_item.light_pos[0])
    stl.y = float(tl_item.light_pos[1])
    stl.state = 0  # RED
    sim.traffic_lights = [stl]
    x_done = float(urban.path[np.argmin(np.abs(urban.path[:, 3] - 420.0)), 0])
    _write_scenario("demo/urban_light", sim,
                    MANAGER_LIGHT.format(t_green=10.0, x_done=x_done,
                                         timeout=70.0))

    # urban_crossing: side-road car conflicts at the intersection
    # (the crossing sits at s = 90 on the crossroad; ego reaches it at
    # ~t = 13 s, the side car at ~t = 11 s, forcing a yield decision)
    sim = _base_state(maps, "urban", s_ego=240.0, v_ego=7.0)
    sim.cars = [_car(maps, "crossroad", s=0.0, v=8.0)]
    x_done = float(urban.path[np.argmin(np.abs(urban.path[:, 3] - 420.0)), 0])
    _write_scenario("demo/urban_crossing", sim,
                    MANAGER_PASS_X.format(x_done=x_done, timeout=60.0))


# --------------------------------------------------------------------------
# param sets

SCENE_PLANNING_PARAMS = "parked_oncoming"


def write_scene_params():
    """The planning param set of demo/parked_oncoming: the vendored
    "demo" set, except that poly_lat_dp_lon samples lateral targets over
    its code-default range.  The demo set gives that family one lateral
    target (l = 0), a lane keeper that stops for good behind a car
    reaching into its lane."""
    from tpl_tpu.planning.dyn_prog.poly_lat_kernel import PolyLatParams

    data = util.load_state_dict(
        os.path.join(REPO_DATA, "params", "planning", "demo"))
    lat = PolyLatParams()
    cpp_lat = data["poly_lat_dp_lon_planner"]["params"]["planner"]["cpp_lat"]
    for k in ("l_dst_min", "l_dst_max", "l_dst_steps"):
        cpp_lat[k] = getattr(lat, k)
    out = os.path.join(REPO_DATA, "params", "planning",
                       SCENE_PLANNING_PARAMS)
    util.save_state_dict(data, out)
    print("wrote", out)


def write_params():
    """Save the framework's default parameter sets as the "demo" set for
    each app (env / planning / control)."""
    import tpl_tpu.planning      # noqa: F401  (planner subclass registry)
    import tpl_tpu.control       # noqa: F401  (controller subclass registry)
    from tpl_tpu.application.environment_app import EnvironmentApp
    from tpl_tpu.application.planning_app import (
        PlanningApp, save_planning_params)
    from tpl_tpu.application.control_app import (
        ControlApp, save_control_params)

    app_id = "make_demo_data"
    env_app = EnvironmentApp(app_id)
    planning_app = PlanningApp(app_id, shared_env=env_app.env)
    control_app = ControlApp(app_id)

    with planning_app.sh_planners.lock():
        planning_app.sh_planners.storage = "demo"
        save_planning_params(planning_app.sh_planners)
    with control_app.sh_controllers.lock():
        control_app.sh_controllers.storage = "demo"
        save_control_params(control_app.sh_controllers)

    # env params: map selection is per-scenario, so the env set carries
    # only the defaults
    out = os.path.join(REPO_DATA, "params", "env", "demo")
    util.save_state_dict(util.Bundle(), out)
    print("wrote", out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", action="store_true",
                    help="also regenerate the demo param sets")
    args = ap.parse_args()

    maps = write_maps()
    write_scenarios(maps)
    if args.params:
        write_params()
    write_scene_params()


if __name__ == "__main__":
    main()
