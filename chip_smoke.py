#!/usr/bin/env python3
"""
Smoke run of the planning and MPC stack on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-4 on one card
    python chip_smoke.py --multi    # the 4-card sharded dry run only

Everything runs in this one process, so one process holds the card.

  0  device check: the default JAX device must be a GPU (no CPU
     fallback); prints the card's name and power limit, the JAX and
     plugin versions and the compile-cache directory.
  1  default deployment, closed loop: SimStandalone on
     demo/parked_oncoming with path_vel_decomp_planner and
     model_predictive_controller.  The scene finishes at 20 s only if
     the ego got past the parked car and the oncoming cars; it must
     finish within MAX_SIM_T, with zero rule violations and no emergency
     trajectory.
  2  the DP families (dp_lat_lon_planner, poly_lat_dp_lon_planner) on
     the same scene at their full default grids; the env-grid and DP
     outputs must live on the GPU.
  3  kernels against the plain references at real widths: lat/lon and
     lon DP (GPU against the same program on the CPU backend, and
     against the numpy oracles at a small grid), the IDM rollout sweep
     (16,384 candidates against the per-candidate vmap oracle), the
     batched tracking MPC (2048 x 60 f32 against the per-instance f64
     solve on the CPU).
  4  the host-pinned latency programs (fused RSTP replan, Solver,
     tracking MPC, poly-sampling) run once on the GPU and compared with
     their pinned runs, with both wall times.

Each phase prints one ``phase N name: {json}`` line; a failed phase
prints its traceback, and the script then exits 1 without the final
line.  The last line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpl_tpu  # noqa: E402,F401  (x64, matmul precision, compile cache)

SCENE = "demo/parked_oncoming"
DEFAULT_PLANNER = "path_vel_decomp_planner"
CONTROLLER = "model_predictive_controller"
DP_PLANNERS = ("dp_lat_lon_planner", "poly_lat_dp_lon_planner")

# lat/lon DP code-default grid (LatLonParams) and the lon DP grid the
# poly_lat_dp_lon driver runs (LonParams with the driver's 20 a-levels)
LATLON_SPEC = dict(t_steps=10, s_steps=201, ds_steps=37, l_steps=21)
LON_SPEC = dict(t_steps=10, s_steps=201, v_steps=37, a_steps=20,
                path_steps=200)
# grids the numpy oracles (tests/test_dp_oracle.py) can afford
LATLON_ORACLE_SPEC = dict(t_steps=4, s_steps=8, ds_steps=5, l_steps=5)
LON_ORACLE_SPEC = dict(t_steps=4, s_steps=7, v_steps=5, a_steps=3,
                       path_steps=8)

DP_COST_TOL = dict(rtol=1e-5, atol=1e-3)
IDM_COST_TOL = dict(rtol=1e-4, atol=1e-4)
MPC_U0_ATOL = 1e-3
MPC_COST_RTOL = 1e-3
PIN_POS_ATOL = 1e-2          # m
PIN_SPEED_ATOL = 1e-2        # m/s
MAX_SIM_T = 60.0             # s; a loop that has not finished by then stalled


def report(phase, name, **fields):
    print(f"phase {phase} {name}: {json.dumps(fields, default=str)}",
          flush=True)


def card_lines():
    """`nvidia-smi --query-gpu=name,power.limit` rows, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_info():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu():
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: the default JAX device is "
                         f"{info['platform']!r}, not a GPU")
    return info


def _versions():
    import importlib.metadata as md
    out = {"jax": jax.__version__}
    for dist in md.distributions():
        name = dist.metadata["Name"] or ""
        if name.lower().startswith(("jaxlib", "jax-cuda", "jax_cuda")):
            out[name] = dist.version
    return out


def _devices_of(tree):
    """Sorted (platform, committed) pairs over the jax arrays of a pytree
    (committed: placed explicitly rather than by default placement)."""
    return sorted({(d.platform, bool(leaf.committed))
                   for leaf in jax.tree.leaves(tree)
                   if isinstance(leaf, jax.Array)
                   for d in leaf.devices()})


def _where(device):
    return str(device) if device is not None else str(jax.devices()[0])


# ---------------------------------------------------------------------
# phases 1 and 2: closed loop
# ---------------------------------------------------------------------

def make_sim(planner, controller=CONTROLLER, scenario=SCENE):
    from tpl_tpu.simulation import SimStandalone

    np.random.seed(0)
    sim = SimStandalone(app_id=f"smoke_{planner}", scenario_path=scenario)
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = planner
    with sim.control_app.sh_controllers.lock():
        sim.control_app.sh_controllers.active_controller = controller
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.settings.reload_if_finished = False
        ss.rule_checker.enable = True
    return sim


def drive(sim, on_tick=None, max_t=MAX_SIM_T):
    """Tick the sim to the scene's finish, a rule violation or ``max_t``
    of simulated time.  Returns the loop record; :func:`check_loop`
    decides pass/fail."""
    ticks = emergency = 0
    violations = []
    t0 = time.perf_counter()
    while True:
        sim.update()
        ticks += 1
        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            finished, sim_t = s.finished, s.t
            violations = [str(v) for v in s.rule_checker.violations]
            ego_x, ego_v = s.ego.x, s.ego.v
        with sim.planning_app.sh_planners.lock():
            emergency += bool(sim.planning_app.sh_planners
                              .trajectory.emergency)
        if on_tick is not None:
            on_tick(sim, ticks)
        if violations or finished or sim_t >= max_t:
            break
    return dict(ticks=ticks, sim_t=round(float(sim_t), 3),
                finished=bool(finished),
                wall_s=round(time.perf_counter() - t0, 3),
                violations=violations[:3], emergency_ticks=emergency,
                ego_x=round(float(ego_x), 2), ego_v=round(float(ego_v), 2))


def check_loop(rec, what):
    if rec["violations"]:
        raise AssertionError(f"{what}: rule violations {rec['violations']}")
    if rec["emergency_ticks"]:
        raise AssertionError(f"{what}: {rec['emergency_ticks']} ticks "
                             "published an emergency trajectory")
    if not rec["finished"]:
        raise AssertionError(f"{what}: the scene never finished (ego at "
                             f"x={rec['ego_x']} m, v={rec['ego_v']} m/s, "
                             f"t={rec['sim_t']} s)")


def phase_default_deployment():
    sim = make_sim(DEFAULT_PLANNER)
    rec = drive(sim)
    check_loop(rec, DEFAULT_PLANNER)
    planner = sim.planning_app.planners[DEFAULT_PLANNER]
    ctrl = sim.control_app.controllers[CONTROLLER]
    rec["stages"] = {
        "environment/prediction": "host numpy",
        "planning (FusedRstpReplan)": _where(planner.fused.device),
        "control (tracking MPC Solver, f64)": _where(ctrl.opt.device),
    }
    return rec


class OutputRecorder:
    """Wraps a jitted stage and records where its outputs live."""

    def __init__(self, fn, sink, name):
        self.fn, self.sink, self.name = fn, sink, name

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.sink[self.name] = _devices_of(out)
        return out


def _attach_recorders(planner, sink):
    """Wrap the DP planner's device stages once they exist."""
    if getattr(planner, "_replan_fused", None) is not None \
            and not isinstance(planner._replan_fused, OutputRecorder):
        planner._replan_fused = OutputRecorder(
            planner._replan_fused, sink, "env_build+latlon_solve")
    chain = getattr(planner, "chain", None)
    if chain is not None and chain._lat_stage is not None \
            and not isinstance(chain._lat_stage, OutputRecorder):
        chain._lat_stage = OutputRecorder(chain._lat_stage, sink,
                                          "lat_stage")
        chain._lon_stage = OutputRecorder(chain._lon_stage, sink,
                                          "lon_stage(lon_dp)")


def phase_dp_families():
    out = {}
    for name in DP_PLANNERS:
        sim = make_sim(name)
        planner = sim.planning_app.planners[name]
        sink = {}
        rec = drive(sim, on_tick=lambda _s, _t: _attach_recorders(
            planner, sink))
        check_loop(rec, name)
        grid = planner.dp_env.cpp_env.grid
        sink["env_grid"] = _devices_of((grid.occ_map, grid.dist_map_lon))
        rec["grid_env"] = list(grid.occ_map.shape)
        if name == "dp_lat_lon_planner":
            cpp = planner.shared.params.planner.cpp
            rec["grid_dp"] = [cpp.t_steps, cpp.s_steps, cpp.ds_steps,
                              cpp.l_steps]
        else:
            cpp = planner.shared.params.planner.cpp_lon
            rec["grid_dp"] = [cpp.t_steps, cpp.s_steps, cpp.v_steps,
                              cpp.a_steps]
        rec["outputs"] = sink
        if len(sink) < 2:
            raise AssertionError(f"{name}: device stages never ran "
                                 f"({sorted(sink)})")
        for stage, places in sink.items():
            if {platform for platform, _ in places} != {"gpu"}:
                raise AssertionError(f"{name}: {stage} outputs on {places}, "
                                     "not on the GPU")
        out[name] = rec
    return out


# ---------------------------------------------------------------------
# phase 3: kernels against the plain references
# ---------------------------------------------------------------------

def _on(device, tree):
    return jax.device_put(tree, device)


def latlon_scene(spec):
    """Env-grid inputs of a lat/lon solve: a straight 200 m reference
    line, a stationary car ahead and a slower car in the left half."""
    from tpl_tpu.planning.dyn_prog.dp_environment import (
        DpEnvironment, DpEnvParams)

    ep = DpEnvParams()
    ep.t_steps, ep.s_steps, ep.l_steps = (spec["t_steps"], spec["s_steps"],
                                          spec["l_steps"])
    env = DpEnvironment()
    env.reinit_buffers(ep)
    n_ref = 401
    rl = np.zeros((n_ref, 9))
    rl[:, 0] = np.arange(n_ref) * 0.5
    rl[:, 3] = rl[:, 0]
    rl[:, 5] = 10.0
    rl[:, 6:8] = 4.0
    env.set_ref_line(rl, 0.5)
    env.insert_geometry(
        [(np.array([[68., -2.], [72., -2.], [72., 0.], [68., 0.]]), t)
         for t in np.arange(10.0)], stationary=True)
    env.insert_geometry(
        [(np.array([[30. + 5 * t, 1.], [34. + 5 * t, 1.],
                    [34. + 5 * t, 3.], [30. + 5 * t, 3.]]), t)
         for t in np.arange(10.0)], stationary=False)
    env.update()
    return env.grid.dist_map_lon, env.grid.ref_line


def _decision_diffs(a, b, cost_a, cost_b, tol):
    """Cells whose chosen action differs; each must be a cost tie."""
    diff = np.any(a != b, axis=-1)
    n = int(diff.sum())
    if n and not np.allclose(cost_a[diff], cost_b[diff], **tol):
        raise AssertionError(f"{n} decisions differ and are not ties")
    return n


def _compare_slice(got, want, decision, constr_exact):
    """One backward slice, (cost, constraint, decisions...) per cell.

    The feasible set (constraint exactly 0) must agree exactly.  With
    ``constr_exact`` the constraint channel must agree bit for bit,
    otherwise within DP_COST_TOL.  The cost must agree within
    DP_COST_TOL in every cell but a constraint tie: an infeasible cell
    whose decision differs while its constraint agrees within tolerance
    (the minimum constraint is the primary key, and two actions whose
    constraints differ by a rounding error are a tie in it that the two
    backends may break either way; with an exact constraint channel
    there is none).  Returns (decision-diff cells, constraint-diff
    cells, max constraint gap, constraint-tie cells)."""
    cost, constr = got[..., 0], got[..., 1]
    cost_r, constr_r = want[..., 0], want[..., 1]
    feasible = constr_r == 0
    n_feas = int(np.sum(feasible != (constr == 0)))
    if n_feas:
        raise AssertionError(f"feasible sets differ in {n_feas} cells")
    constr_diff = constr != constr_r
    if constr_exact and constr_diff.any():
        i = tuple(int(k[0]) for k in np.nonzero(constr_diff))
        raise AssertionError(f"constraint channel differs in "
                             f"{int(constr_diff.sum())} cells, e.g. {i}: "
                             f"{got[i].tolist()} vs {want[i].tolist()}")
    if not np.allclose(constr, constr_r, **DP_COST_TOL):
        raise AssertionError(f"constraint beyond {DP_COST_TOL}")
    dec_diff = np.any(got[..., decision] != want[..., decision], axis=-1)
    cost_off = ~np.isclose(cost, cost_r, **DP_COST_TOL)
    tie = cost_off & ~feasible & dec_diff
    bad = cost_off & ~tie
    if bad.any():
        i = tuple(int(k[0]) for k in np.nonzero(bad))
        raise AssertionError(f"DP cost beyond {DP_COST_TOL} in "
                             f"{int(bad.sum())} cells, e.g. {i}: "
                             f"{got[i].tolist()} vs {want[i].tolist()}")
    return (int(dec_diff.sum()), int(constr_diff.sum()),
            float(np.max(np.abs(constr - constr_r))), int(tie.sum()))


def compare_dp(solve, args, dev, ref_dev, decision, traj_cols, traj_cost,
               constr_exact):
    """One DP solve on ``dev`` against the same program on ``ref_dev``.

    The chosen trajectories are compared whole: a step whose action
    differs must be a cost tie.  The value tables are compared slice by
    slice (:func:`_compare_slice`): ``solve.backward_step`` runs on both
    devices from the same next-slice nodes (the reference solve's).
    Whole tables are not compared: the lexicographic (constraint, cost)
    minimum is discontinuous, so one rounding difference that breaks a
    cost tie the other way in one slice changes what the slices before
    it are penalised against."""
    nodes, traj = (np.asarray(x) for x in solve(*_on(dev, args)))
    nodes_r, traj_r = (np.asarray(x) for x in solve(*_on(ref_dev, args)))
    n_steps = _decision_diffs(traj[:, traj_cols], traj_r[:, traj_cols],
                              traj[:, traj_cost], traj_r[:, traj_cost],
                              DP_COST_TOL)
    T = nodes_r.shape[0]
    pairs = [(nodes[T - 1], nodes_r[T - 1])]
    tail = args[:-1]                      # the solve's inputs but x0
    for i in range(T - 2, 0, -1):
        step_in = (nodes_r[i + 1], jnp.int32(i)) + tail
        pairs.append(tuple(np.asarray(solve.backward_step(*_on(d, step_in)))
                           for d in (dev, ref_dev)))
    diffs, n_constr, gaps, ties = zip(*(
        _compare_slice(got, want, decision, constr_exact)
        for got, want in pairs))
    return dict(slices=len(pairs), decision_diff_cells=sum(diffs),
                traj_decision_diff_steps=n_steps,
                constr_diff_cells=sum(n_constr), max_constr_gap=max(gaps),
                constr_tie_cells=sum(ties),
                cells_per_slice=int(np.prod(nodes_r.shape[1:-1]))), traj


def compare_latlon(spec, dev, ref_dev):
    from tpl_tpu.planning.dyn_prog import lat_lon_kernel as llk

    solve, _ = llk.make_latlon_solver(spec)
    dist_map, ref_line = latlon_scene(spec)
    pp = llk.LatLonParams()
    pp.t_steps, pp.s_steps = spec["t_steps"], spec["s_steps"]
    pp.ds_steps, pp.l_steps = spec["ds_steps"], spec["l_steps"]
    x0 = np.zeros(12, np.float32)
    x0[llk.C_DS] = 8.0
    args = (dist_map, ref_line, jnp.float32(0.5), pp.dynamic_dict(),
            jnp.asarray(x0))
    t0 = time.perf_counter()
    jax.block_until_ready(solve(*_on(dev, args)))
    t_dev = time.perf_counter() - t0
    out, traj = compare_dp(solve, args, dev, ref_dev, [2, 3],
                           [llk.C_DDS, llk.C_DL], llk.C_COST,
                           constr_exact=True)
    return dict(out, grid=list(spec.values()), first_call_s=round(t_dev, 3),
                s_end=float(traj[-1, llk.C_S]))


def lon_scene(spec, pp):
    P, T, S = spec["path_steps"], spec["t_steps"], spec["s_steps"]
    path = np.zeros((P, 7), np.float32)
    dists = np.arange(P, dtype=np.float32) * np.float32(pp.path_step_size)
    path[:, 0] = dists
    path[:, 2] = dists
    path[:, 5] = 14.0 - 6.0 * (np.arange(P) > P // 2)
    path[:, 6] = dists
    s = np.linspace(pp.s_min, pp.s_max, S, dtype=np.float32)
    dist_path = (np.maximum(0.0, 120.0 - s)[None, :]
                 + 4.0 * np.arange(T, dtype=np.float32)[:, None])
    return dist_path.astype(np.float32), path


def compare_lon(spec, dev, ref_dev):
    from tpl_tpu.planning.dyn_prog import lon_kernel as lk

    solver, _ = lk.make_lon_solver(spec)
    pp = lk.LonParams()
    for k in ("t_steps", "s_steps", "v_steps", "a_steps", "path_steps"):
        setattr(pp, k, spec[k])
    pp.path_step_size = (pp.s_max - pp.s_min) / (spec["path_steps"] - 1)
    dist_path, path = lon_scene(spec, pp)
    x0 = np.zeros(7, np.float32)
    x0[lk.LC_V] = 8.0
    args = (jnp.asarray(dist_path), jnp.asarray(path), pp.dynamic_dict(),
            jnp.asarray(x0))
    out, _ = compare_dp(solver, args, dev, ref_dev, [2], [lk.LC_J],
                        lk.LC_COST, constr_exact=False)
    return dict(out, grid=list(spec.values()))


def _load_dp_oracle():
    """tests/test_dp_oracle.py, loaded by path: the tests directory is not
    a package, and another ``tests`` package may be importable."""
    import importlib.util
    path = os.path.join(REPO, "tests", "test_dp_oracle.py")
    spec = importlib.util.spec_from_file_location("_smoke_dp_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_dp_oracles(dev):
    """The device solves at small grids against the naive numpy twins
    of the CUDA semantics (tests/test_dp_oracle.py)."""
    from tpl_tpu.planning.dyn_prog import lat_lon_kernel as llk
    from tpl_tpu.planning.dyn_prog import lon_kernel as lk

    oracle = _load_dp_oracle()
    spec = LATLON_ORACLE_SPEC
    pp, ref_line, ref_step, dist_x = oracle._ll_scene(spec)
    solve, _ = llk.make_latlon_solver(spec)
    dist_map = np.stack([dist_x, dist_x], axis=-1)
    nodes, _ = solve(*_on(dev, (jnp.asarray(dist_map), jnp.asarray(ref_line),
                                jnp.asarray(ref_step), pp.dynamic_dict(),
                                jnp.zeros(12, jnp.float32))))
    nodes = np.asarray(nodes)
    want = oracle.ll_oracle_backward(dist_x, ref_line, float(ref_step), pp)
    np.testing.assert_allclose(nodes[1:, ..., :2], want[1:, ..., :2],
                               **DP_COST_TOL, err_msg="lat/lon oracle")

    spec_l = LON_ORACLE_SPEC
    ppl = oracle._lon_pp(spec_l)
    path = np.zeros((ppl.path_steps, 7), np.float32)
    dists = np.arange(ppl.path_steps, dtype=np.float32) \
        * np.float32(ppl.path_step_size)
    path[:, lk.PC_X] = path[:, lk.PC_S] = path[:, lk.PC_DIST] = dists
    path[:, lk.PC_VMAX] = 10.0 - 0.3 * np.arange(ppl.path_steps)
    dist_path = (np.maximum(0.0, 18.0 - np.arange(
        ppl.s_steps, dtype=np.float32) * np.float32(ppl.s_step))[None, :]
        + np.arange(ppl.t_steps, dtype=np.float32)[:, None] * 1.3
    ).astype(np.float32)
    solver, _ = lk.make_lon_solver(spec_l)
    nodes_l, _ = solver(*_on(dev, (jnp.asarray(dist_path), jnp.asarray(path),
                                   ppl.dynamic_dict(),
                                   jnp.zeros(7, jnp.float32))))
    nodes_l = np.asarray(nodes_l)
    want_l = oracle.lon_oracle_backward(dist_path, path, ppl)
    np.testing.assert_allclose(nodes_l[1:, ..., :2], want_l[1:, ..., :2],
                               **DP_COST_TOL, err_msg="lon oracle")
    return dict(latlon_grid=list(spec.values()),
                lon_grid=list(spec_l.values()))


def compare_idm(candidates, subset, dev, ref_dev):
    """Lanes-form sweep on ``dev`` against the per-candidate vmap
    oracle on ``ref_dev`` for every (candidates // subset)-th candidate."""
    import bench

    kernel, args = bench._idm_setup(candidates)
    t0 = time.perf_counter()
    _refs, _cons, costs = jax.block_until_ready(kernel(*_on(dev, args)))
    t_dev = time.perf_counter() - t0

    (init_ref, init_con, l_trgs, d_stops, dt_replan, rl, ref_step, objs,
     ppd, l_trg_global) = _on(ref_dev, args)
    sub = np.arange(0, candidates, candidates // subset)
    refs_o, cons_o = kernel.rollout_ref(
        init_ref, init_con, l_trgs[sub], d_stops[sub], dt_replan, rl,
        ref_step, objs, ppd)
    want_all = kernel.evaluate_ref(refs_o, cons_o, l_trgs[sub], objs, rl,
                                   ref_step, ppd, l_trg_global)
    for k, v in want_all.items():      # every cost term and verdict
        np.testing.assert_allclose(np.asarray(costs[k])[sub], np.asarray(v),
                                   **IDM_COST_TOL, err_msg=f"IDM {k}")
    got, want = np.asarray(costs["cost"])[sub], np.asarray(want_all["cost"])
    i_got, i_want = int(np.argmin(got)), int(np.argmin(want))
    tie = i_got != i_want
    if tie and not np.isclose(got[i_got], want[i_want], **IDM_COST_TOL):
        raise AssertionError(f"IDM argmin {i_got} vs oracle {i_want}")
    return dict(candidates=candidates, compared=len(sub),
                terms=sorted(want_all), first_call_s=round(t_dev, 3),
                argmin=int(sub[i_got]), argmin_tie=tie,
                best_cost=float(got[i_got]),
                invalid=int(np.sum(np.asarray(want_all["invalid"]))))


def compare_mpc(batch, horizon, n_check, dev, ref_dev):
    """Lanes-batched f32 solve on ``dev`` against the per-instance f64
    solve (ilqr.make_update_fn under vmap) on ``ref_dev``."""
    import bench
    import __graft_entry__ as ge

    lupdate, args = bench._mpc_batched_setup(batch, horizon)
    _xs, u, _lam, _mu, costs = jax.block_until_ready(
        lupdate(*_on(dev, args)))
    sub = np.arange(0, batch, batch // n_check)
    u0 = np.asarray(u)[0, :, sub]                    # (n_check, nu)
    costs = np.asarray(costs)[sub]

    with jax.default_device(ref_dev):
        update, state, x0, params, cfg = ge._mpc_setup(
            dtype=jnp.float64, horizon=horizon)
        bstate = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (len(sub),) + a.shape), state)
        bx0 = bench.mpc_batch_x0(x0, batch)[sub]
        new_state, info = jax.jit(jax.vmap(
            update, in_axes=(0, 0, None, None)))(bstate, bx0, params, cfg)
        u0_ref = np.asarray(new_state.u[:, 0])
        costs_ref = np.asarray(info["traj_costs"])
    np.testing.assert_allclose(u0, u0_ref, rtol=0.0, atol=MPC_U0_ATOL,
                               err_msg="MPC u[0]")
    np.testing.assert_allclose(costs, costs_ref, rtol=MPC_COST_RTOL,
                               err_msg="MPC trajectory cost")
    return dict(batch=batch, horizon=horizon, compared=len(sub),
                max_u0_diff=float(np.max(np.abs(u0 - u0_ref))),
                max_cost_rel_diff=float(np.max(
                    np.abs(costs - costs_ref) / np.abs(costs_ref))))


def run_checks(checks):
    """Run every (name, fn, extra) check; a failure does not hide the
    others.  Returns {name: result | extra}, or raises listing the failed
    checks after printing the partial results to stderr."""
    out, failed = {}, []
    for name, fn, extra in checks:
        try:
            out[name] = dict(fn(), **extra)
        except Exception:        # re-raised below, after the other checks
            traceback.print_exc()
            failed.append(name)
    if failed:
        print(json.dumps(out, default=str), file=sys.stderr)
        raise AssertionError(f"failed checks: {failed}")
    return out


def phase_kernels():
    gpu = jax.devices()[0]
    cpu = jax.local_devices(backend="cpu")[0]
    prec = ("f32 on the GPU against the same f32 program on the CPU "
            "backend; jax_default_matmul_precision=highest")
    ties = ("an infeasible cell whose decision differs while its "
            "constraint agrees is a constraint tie; its cost is not compared")
    latlon_tol = dict(tol=dict(cost=DP_COST_TOL, constr="exact",
                               feasible_set="exact"), precision=prec)
    # The lon constraint channel is interpolated from the next slice's
    # table, and the two backends round that arithmetic differently:
    # f32 division on the GPU is not correctly rounded, and the CPU
    # backend fuses multiply-adds, the GPU backend does not.
    lon_tol = dict(tol=dict(cost=DP_COST_TOL, constr=DP_COST_TOL,
                            feasible_set="exact", ties=ties),
                   precision=prec)
    return run_checks([
        ("latlon_dp", lambda: compare_latlon(LATLON_SPEC, gpu, cpu),
         latlon_tol),
        ("lon_dp", lambda: compare_lon(LON_SPEC, gpu, cpu), lon_tol),
        ("dp_oracles", lambda: compare_dp_oracles(gpu),
         dict(tol=DP_COST_TOL, precision="f32 GPU against f32 numpy")),
        ("idm_sweep", lambda: compare_idm(16384, 1024, gpu, cpu),
         dict(tol=IDM_COST_TOL, precision="f32 lanes form on the GPU "
              "against the f32 per-candidate vmap on the CPU")),
        ("batched_mpc", lambda: compare_mpc(2048, 60, 64, gpu, cpu),
         dict(tol=dict(u0_atol=MPC_U0_ATOL, cost_rtol=MPC_COST_RTOL),
              precision="f32 lanes engine on the GPU against f64 "
              "per-instance iLQR on the CPU")),
    ])


# ---------------------------------------------------------------------
# phase 4: host-pinned latency programs, once on the GPU
# ---------------------------------------------------------------------

@contextlib.contextmanager
def _nolock():
    yield


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


PIN_WINDOW = 60    # trajectory points compared against the tolerances


def _traj_diff(a, b):
    """Max position and speed differences over the first PIN_WINDOW
    points (60 points at 0.5 m cover the 3 s the tracking MPC reads at
    ~10 m/s), then over the whole trajectory (reported, not checked)."""
    out = []
    for n in (PIN_WINDOW, None):
        sl = slice(0, n)
        dxy = np.hypot(np.asarray(a.x)[sl] - np.asarray(b.x)[sl],
                       np.asarray(a.y)[sl] - np.asarray(b.y)[sl])
        dv = np.abs(np.asarray(a.velocity)[sl] - np.asarray(b.velocity)[sl])
        out += [float(dxy.max()), float(dv.max())]
    return out


class PinCompare:
    """Accumulates one pinned-vs-GPU comparison: max position and speed
    differences (checked), the same over the whole output (reported
    only) and the mean wall time of each side (first call, which
    compiles, excluded)."""

    def __init__(self):
        self.dxy = self.dv = self.dxy_all = self.dv_all = 0.0
        self.wall = {"pinned": [], "gpu": []}
        self.n = 0

    def add(self, t_pin, t_gpu, dxy, dv, dxy_all=None, dv_all=None):
        self.n += 1
        self.wall["pinned"].append(t_pin)
        self.wall["gpu"].append(t_gpu)
        self.dxy, self.dv = max(self.dxy, dxy), max(self.dv, dv)
        self.dxy_all = max(self.dxy_all, dxy if dxy_all is None else dxy_all)
        self.dv_all = max(self.dv_all, dv if dv_all is None else dv_all)

    def result(self):
        if not self.n:
            raise AssertionError("nothing compared")
        if self.dxy > PIN_POS_ATOL or self.dv > PIN_SPEED_ATOL:
            raise AssertionError(f"pinned vs GPU: position {self.dxy} m, "
                                 f"speed {self.dv} m/s")
        ms = {k: round(1e3 * float(np.mean(v[1:] or v)), 3)
              for k, v in self.wall.items()}
        return dict(compared=self.n, max_pos_diff_m=self.dxy,
                    max_speed_diff_mps=self.dv,
                    whole_output=dict(max_pos_diff_m=self.dxy_all,
                                      max_speed_diff_mps=self.dv_all),
                    mean_wall_ms=ms)


def _rstp_twins(use_fused):
    from tpl_tpu.planning.path_vel_decomp.path_vel_decomp_planner import (
        PathVelDecompPlanner)
    from tpl_tpu.planning.path_vel_decomp.fused_replan import (
        FusedRstpReplan)
    from tpl_tpu.util import Bundle

    twins = []
    for pinned in (True, False):
        p = PathVelDecompPlanner(Bundle(), _nolock)
        p.shared.params.use_fused = use_fused
        if not pinned:
            if use_fused:
                p.fused = FusedRstpReplan(
                    horizon_max=max(16, int(p.shared.params.horizon)),
                    device=None)
            else:
                for stage in (p.path_optim, p.velocity_optim,
                              p.path_smoothing):
                    stage.opt.device = None
        twins.append(p)
    return twins


RSTP_WARM_TICKS = 12


def compare_rstp(use_fused, ticks=36, every=3, warm=RSTP_WARM_TICKS):
    """Two RSTP planner instances, pinned and on the GPU, fed the same
    environment every ``every`` ticks of the default closed loop.  The
    first ``warm`` ticks are not compared: cold-start solves stop at the
    iteration cap before they converge, so the two sides' rounding
    leaves them apart.  Points past PIN_WINDOW are reported only: the
    far end of the 250-point horizon converges last."""
    pin, gpu = _rstp_twins(use_fused)
    sim = make_sim(DEFAULT_PLANNER)
    cmp_ = PinCompare()
    for i in range(ticks):
        sim.update()
        if i % every:
            continue
        env = sim.env_app.env
        a, ta = _timed(pin.update, env)
        b, tb = _timed(gpu.update, env)
        if i >= warm:
            cmp_.add(ta, tb, *_traj_diff(a, b))
    return cmp_.result()


MPC_WARM_TICKS = 5


def compare_tracking_mpc(ticks=30, warm=MPC_WARM_TICKS):
    from tpl_tpu.control.model_predictive_controller import (
        ModelPredictiveController)
    from tpl_tpu.application.control_app import ControlInput
    from tpl_tpu.util import Bundle, snapshot

    sim = make_sim(DEFAULT_PLANNER)
    live = sim.control_app.controllers[CONTROLLER]
    twins = []
    for pinned in (True, False):
        c = ModelPredictiveController(Bundle(), _nolock)
        with live.lock_shared():
            c.shared.params = snapshot(live.shared.params)
        if not pinned:
            c.opt.device = None
        twins.append(c)
    cmp_ = PinCompare()
    sh = sim.control_app.sh_input
    for i in range(ticks):
        sim.update()
        ci = ControlInput()
        with sh.lock():
            ci.t = sh.t
            ci.vehicle = snapshot(sh.vehicle)
            ci.trajectory = snapshot(sh.trajectory)
        (_, a), ta = _timed(twins[0].update, ci)
        (_, b), tb = _timed(twins[1].update, ci)
        if i >= warm:
            cmp_.add(ta, tb, *_traj_diff(a, b))
    return cmp_.result()


def compare_poly_sampling(calls=8):
    import bench
    from tpl_tpu.planning.poly_sampling import poly_sampling_planner as psp

    start, path, obstacles, pp = bench._poly_sampling_setup()
    cmp_ = PinCompare()
    for i in range(calls):
        st = dict(start, d=0.5 - 0.1 * i, s_d=8.0 + 0.25 * i)
        a, ta = _timed(psp._eval_candidates_device, st, path, obstacles, pp,
                       "cpu")
        b, tb = _timed(psp._eval_candidates_device, st, path, obstacles, pp,
                       None)
        dxy = float(np.max(np.hypot(a["x"] - b["x"], a["y"] - b["y"])))
        dv = float(np.max(np.abs(a["s_d"] - b["s_d"])))
        cmp_.add(ta, tb, dxy, dv)
    return cmp_.result()


def phase_pinned(card):
    tol = dict(pos_atol_m=PIN_POS_ATOL, speed_atol_mps=PIN_SPEED_ATOL,
               window_points=PIN_WINDOW)
    rstp_tol = dict(tol, warm_ticks_skipped=RSTP_WARM_TICKS)
    out = run_checks([
        ("fused_rstp_replan", lambda: compare_rstp(use_fused=True),
         dict(tol=rstp_tol, precision="f32 both")),
        ("solver_rstp_host_pipeline", lambda: compare_rstp(use_fused=False),
         dict(tol=rstp_tol, precision="f32 both")),
        ("tracking_mpc", compare_tracking_mpc,
         dict(tol=dict(tol, warm_ticks_skipped=MPC_WARM_TICKS),
              precision="f64 both")),
        ("poly_sampling", compare_poly_sampling,
         dict(tol=dict(tol, window_points="all"), precision="f32 both")),
    ])
    return dict(card=card, **out)


# ---------------------------------------------------------------------
# --multi: the sharded dry run on four cards
# ---------------------------------------------------------------------

MULTI_RTOL = 1e-5


def compare_multichip(n_devices):
    """__graft_entry__.dryrun_multichip on ``n_devices`` devices against
    the same batches on one device."""
    import __graft_entry__ as ge

    devices = jax.devices()[:n_devices]
    if len(devices) < n_devices:
        raise AssertionError(f"{n_devices} devices asked, "
                             f"{len(jax.devices())} present")
    many = ge.dryrun_multichip(n_devices)
    one = ge.dryrun_multichip(n_devices, mesh_devices=devices[:1])
    for k in many:
        if not np.isclose(many[k], one[k], rtol=MULTI_RTOL, atol=0.0):
            raise AssertionError(f"{k}: {n_devices} devices {many[k]} vs "
                                 f"one device {one[k]}")
    return dict(devices=n_devices, sharded=many, single=one,
                tol=dict(rtol=MULTI_RTOL))


# ---------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded dry run")
    args = ap.parse_args(argv)

    info = require_gpu()
    cards = card_lines()
    for c in cards:
        print(f"card: {c}", flush=True)
    report(0, "device", **info, cards=cards, versions=_versions(),
           compile_cache=jax.config.jax_compilation_cache_dir,
           x64=bool(jax.config.jax_enable_x64),
           matmul_precision=jax.config.jax_default_matmul_precision)

    if args.multi:
        phases = [(5, "multichip", lambda: compare_multichip(4))]
    else:
        phases = [
            (1, "default_deployment", phase_default_deployment),
            (2, "dp_families", phase_dp_families),
            (3, "kernels", phase_kernels),
            (4, "pinned_on_gpu", lambda: phase_pinned(cards[0])),
        ]
    failed = []
    for n, name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:          # reported, and the run exits 1 below
            traceback.print_exc()
            failed.append(name)
            report(n, name, ok=False,
                   phase_wall_s=round(time.perf_counter() - t0, 3))
            continue
        report(n, name, ok=True,
               phase_wall_s=round(time.perf_counter() - t0, 3), result=res)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
