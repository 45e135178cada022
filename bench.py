"""
Benchmark harness. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Measures (BASELINE.json metric: "MPC solves/s/chip + p99 replan latency
(RSTP, 100-step horizon)"; target >= 10k batched rollouts/s/chip):
  - batched closed-loop rollouts per second per chip (IDM sampling kernel:
    100-step Stanley+IDM rollouts with leader lookups and SAT collision
    evaluation against 12 predicted objects)
  - batched MPC tracking solves per second per chip (full AL-iLQR solves,
    batch-in-lanes engine)
  - single-instance RSTP replan latency p99 (lateral profile + velocity
    profile solves on a 100-step horizon, warm-started, like one
    receding-horizon tick)
  - per-replan latency of the DP / sampling planner families, on the
    host CPU backend and on the default device

Every measurement runs in a child process of its own, one after
another: the parent never opens the accelerator, so exactly one process
holds the card at a time (a JAX process reserves most of the card's
memory when it first touches it).  Device timings wait for the result
with ``block_until_ready``.

vs_baseline: rollouts/s against the 10k rollouts/s/chip target.

Run: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

LEG_TIMEOUT_S = 900.0


def mpc_batch_x0(x0, batch):
    """Initial states of the MPC sweep: the flagship state with the
    lateral offset spread over +-1 m and the speed over +-2 m/s, so every
    instance is a plausible tracking problem (state layout
    [x, y, phi, delta, v, s, a])."""
    import jax.numpy as jnp

    u = jnp.linspace(-1.0, 1.0, batch, dtype=x0.dtype)
    return (jnp.broadcast_to(x0, (batch,) + x0.shape)
            .at[:, 1].add(u).at[:, 4].add(2.0 * u[::-1]))


def _mpc_batched_setup(batch=2048, horizon=60, max_iterations=8):
    """Build the lanes-batched AL-iLQR update and its call args (shared
    by the bench and chip_smoke.py)."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from tpl_tpu.optim import batched, ilqr

    update, state, x0, params, cfg = ge._mpc_setup(
        horizon=horizon, max_iterations=max_iterations)
    prob, _spec = ge._mpc_problem()
    lupdate = batched.make_batched_update_fn(
        prob, horizon, batch, integrator=ilqr.HEUN)

    bstate = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), state)
    bx0 = mpc_batch_x0(x0, batch)
    xl = jnp.transpose(bstate.x, (1, 2, 0))
    ul = jnp.transpose(bstate.u, (1, 2, 0))
    laml = jnp.transpose(bstate.lam, (1, 2, 0))
    mus = jnp.zeros((batch,), jnp.int32)
    return lupdate, (xl, ul, laml, mus, bx0.T, params, cfg)


def _device_time(call, iters):
    """Median seconds of one steady-state dispatch: warm (compile + first
    run), then ``iters`` timed calls, each waited for with
    ``block_until_ready``."""
    import jax

    jax.block_until_ready(call())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_batched_mpc(batch=2048, horizon=60, max_iterations=8, iters=10):
    """Full AL-iLQR tracking-MPC solves/s via the batch-in-lanes engine
    (tpl_tpu/optim/batched.py)."""
    lupdate, args = _mpc_batched_setup(batch, horizon, max_iterations)
    return batch / _device_time(lambda: lupdate(*args), iters)


def _idm_setup(candidates=16384):
    """Build the IDM rollout kernel and its call args (shared by the
    bench and chip_smoke.py)."""
    import jax.numpy as jnp
    from tpl_tpu.planning.idm_sampling import idm_kernel
    from tpl_tpu.planning.idm_sampling.idm_kernel import IdmSamplingParams

    NR = 801
    spec = dict(steps_t=100, n_ref=NR, n_obj=12, n_pred=16, n_hull=16)
    kernel = idm_kernel.make_idm_kernel(spec)

    rl = np.zeros((NR, 7), np.float32)
    rl[:, 0] = np.arange(NR) * 0.5 - 200.0
    rl[:, 4] = 12.0
    rl[:, 5] = 4.0
    rl[:, 6] = 4.0

    objs = dict(
        pred_t=np.tile(np.arange(16, dtype=np.float32), (12, 1)),
        pred_xy=np.zeros((12, 16, 2), np.float32),
        pred_heading=np.zeros((12, 16), np.float32),
        pred_v=np.zeros((12, 16), np.float32),
        pred_dists=np.tile(np.arange(16, dtype=np.float32), (12, 1)),
        hull_preds=np.zeros((12, 16, 16, 2), np.float32),
        hull_projs=np.full((12, 16, 4), -1000.0, np.float32),
        radius_hull=np.ones(12, np.float32),
        valid=np.ones(12, bool),
        on_local_map=np.ones(12, bool))
    box = np.array([[-2, -1], [2, -1], [2, 1], [-2, 1]] * 4, np.float32)
    for i in range(12):
        objs["pred_xy"][i, :, 0] = 30.0 + 10 * i + np.arange(16) * 2.0
        objs["pred_xy"][i, :, 1] = (i % 3 - 1) * 2.5
        objs["hull_preds"][i] = objs["pred_xy"][i][:, None, :] + box[None]

    pp = IdmSamplingParams()
    pp.width_veh = 2.0
    pp.length_veh = 5.0
    pp.radius_veh = 2.7
    pp.dist_front_veh = 3.8
    pp.dist_back_veh = -1.1
    ppd = pp.dynamic_dict()

    init_ref = np.zeros(10, np.float32)
    init_ref[4] = 8.0
    init_con = np.zeros(9, np.float32)
    init_con[5] = 8.0

    C = candidates
    l_trgs = jnp.asarray(np.linspace(-3, 3, C), jnp.float32)
    d_stops = jnp.full(C, 1e6, jnp.float32)
    objs_dev = {k: jnp.asarray(v) for k, v in objs.items()}

    args = (jnp.asarray(init_ref), jnp.asarray(init_con),
            l_trgs, d_stops, jnp.float32(0.1), jnp.asarray(rl),
            jnp.float32(0.5), objs_dev, ppd, jnp.float32(0.0))
    return kernel, args


def bench_idm_rollouts(candidates=16384, iters=10):
    """Closed-loop rollout throughput (the BASELINE.json rollout target).

    16k candidates per dispatch: the kernel evaluates them in 1024-wide
    chunks (idm_kernel.py run()).  The scene stays device-resident across
    dispatches and only the candidate parameters vary, as in a
    production sweep."""
    kernel, kargs = _idm_setup(candidates)
    return candidates / _device_time(lambda: kernel(*kargs), iters)


def _poly_sampling_setup():
    """A straight 250 m path with eight obstacles ahead, the planner's
    candidate-grid params, and a start state (shared by the bench and
    chip_smoke.py).  Returns (start, path, obstacles, params)."""
    from tpl_tpu.planning.poly_sampling import poly_sampling_planner as psp

    N = 500
    path = np.zeros((N, 6))
    path[:, 0] = np.arange(N) * 0.5
    path[:, 3] = path[:, 0]
    path[:, 5] = 10.0
    start = dict(d=0.5, d_d=0.1, d_dd=0.0, s=0.0, s_d=8.0, s_dd=0.0)
    obstacles = [dict(hull=np.array(
        [[30. + 12 * i, -1.], [34. + 12 * i, -1.],
         [34. + 12 * i, 1.], [30. + 12 * i, 1.]])) for i in range(8)]
    pp = psp.PolySamplingParams()
    pp.lane_width = 3.0
    pp.v_samples = 2
    pp.rear_axis_to_rear = 1.0
    pp.rear_axis_to_front = 4.0
    pp.width_ego = 2.5
    return start, path, obstacles, pp


def bench_poly_sampling(iters=200, warmup=20):
    """Per-tick latency of the poly-sampling planner's candidate
    evaluation (full Werling grid + SAT screen + argmin, one dispatch;
    poly_kernel.py), measured through the production per-tick path —
    which pins the dispatch to the host CPU backend like the other
    latency-bound solvers (poly_sampling_planner._eval_candidates_device).
    Returns (p99_ms, mean_ms)."""
    from tpl_tpu.planning.poly_sampling import poly_sampling_planner as psp

    start, path, obstacles, pp = _poly_sampling_setup()
    for _ in range(warmup):
        psp._eval_candidates_device(start, path, obstacles, pp)
    lats = []
    for _ in range(iters):
        t0 = time.perf_counter()
        psp._eval_candidates_device(start, path, obstacles, pp)
        lats.append(time.perf_counter() - t0)
    lats = np.array(lats) * 1e3
    return float(np.percentile(lats, 99)), float(np.mean(lats))


def run_leg(leg, *extra, host=False):
    """Run one measurement in a child process and return its JSON line.

    Each leg is its own process, started only after the previous one
    exited, so at most one process holds the accelerator; the planners
    also run as their own process in deployment (SURVEY §1).  ``host``
    pins the child to the host CPU backend."""
    env = dict(os.environ)
    if host:
        env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--leg", leg, *extra],
        capture_output=True, timeout=LEG_TIMEOUT_S, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise RuntimeError(f"bench leg {leg} {extra} failed (rc={r.returncode}):"
                       f"\n{r.stderr[-2000:]}")


# per-family bench adapters: where the replan cadence param lives, how a
# completed replan is detected, and which stage runtimes the driver
# records (the reference logs runtimes for every planner,
# library/test/test_sim.py:80-105)
_FAMILY = {
    "dp_lat_lon_planner": dict(
        params_sub="planner", cadence="replan_time_step",
        marker=lambda p: p.policy.last_replan_time,
        split=lambda p: {
            "env_host_prep_ms": p.dp_env.runtime_environment,
            "solve_ms": p.runtime_dp,
            "smooth_ms": getattr(p, "runtime_smooth", 0.0)}),
    "poly_lat_dp_lon_planner": dict(
        params_sub="planner", cadence="replan_time_step",
        marker=lambda p: p.policy.last_replan_time,
        split=lambda p: {
            "env_host_prep_ms": p.dp_env.runtime_environment,
            "solve_ms": p.runtime_dp,
            "smooth_ms": getattr(p, "runtime_smooth", 0.0)}),
    "lattice_planner": dict(
        params_sub="planner", cadence="reinit_time",
        marker=lambda p: p.policy.last_replan_time,
        split=lambda p: {
            "env_host_prep_ms": p.dp_env.runtime_environment,
            "solve_ms": p.runtime_dp}),
    "dp_poly_planner": dict(
        params_sub=None, cadence="replan_time",
        marker=lambda p: p.behavior.last_replan_time,
        split=lambda p: {
            "env_host_prep_ms": p.runtime_environment,
            "solve_ms": p.runtime_planning}),
    "idm_sampling_planner": dict(
        params_sub=None, cadence="replan_time",
        marker=lambda p: p.last_update_time,
        split=lambda p: {"solve_ms": p.runtime_planning}),
}


SCENE = "demo/parked_oncoming"


def bench_dp_replan(planner_name="dp_lat_lon_planner",
                    scenario=SCENE, replans=100,
                    warmup_replans=10, replan_time_step=0.2):
    """One real receding-horizon DP replan tick through the actual driver
    (reference timing shape: library/tpl/planning/dyn_prog/
    dp_lat_lon_planner.py:138-140 runtime_dp + dp_env.py:126,172
    runtime_environment).

    Drives the full closed-loop pipeline and times only the planning
    stage of passes where the driver actually replanned (the DP families
    replan at replan_time_step cadence; in-between passes are host
    stitching and are not the latency story).  Returns per-replan stats
    plus the stage split the drivers record themselves:
      * env_host_prep_ms — host-side grid packing (dp_env.build_grids
        with the device build deferred into the fused program)
      * solve_ms — fused device env-build + DP solve dispatch including
        the trajectory pull (runtime_dp)
      * smooth_ms — LQR smoothing + Frenet->Cartesian post-processing
        (dp_lat_lon only; the poly_lat_dp_lon driver has no separate
        smoothing stage)
    Whether this measures the host or the device path is decided by the
    process's JAX platform (the driver dispatches to the default
    device); the caller sets JAX_PLATFORMS accordingly.

    The production param sets replan at 0.5 s cadence (both frameworks:
    reference data/params/planning/default/state.json replan_time_step
    = 0.5); the bench tightens the cadence to ``replan_time_step`` so
    one scenario pass yields enough replan samples — per-replan latency
    is unaffected, only the sampling rate."""
    import gc
    np.random.seed(0)
    from tpl_tpu.simulation import SimStandalone

    fam = _FAMILY[planner_name]
    sim = SimStandalone(app_id="benchdp", scenario_path=scenario)
    with sim.planning_app.sh_planners.lock():
        sim.planning_app.sh_planners.active_planner = planner_name
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False
        ss.settings.reload_if_finished = False

    planner = sim.planning_app.planners[planner_name]
    with planner.lock_shared():
        pbundle = planner.shared.params
        if fam["params_sub"] is not None:
            pbundle = getattr(pbundle, fam["params_sub"])
        # tighten the cadence only (more samples per scenario pass);
        # never slow a planner that already replans faster
        cadence = min(replan_time_step, getattr(pbundle, fam["cadence"]))
        setattr(pbundle, fam["cadence"], cadence)

    wall, splits = [], []
    warmed = 0
    ticks_per_replan = max(1, int(round(cadence / 0.01)))
    max_ticks = 2 * ticks_per_replan * (warmup_replans + replans) + 500
    for _ in range(max_ticks):
        # the sim pipeline, opened up so ONLY the planning stage is
        # timed (physics/perception/control stay out of the numbers)
        sim_state = sim._step_physics(None)
        vehicle = sim._step_perception(sim_state.t)
        before = fam["marker"](planner)
        t0 = time.perf_counter()
        trajectory = sim._step_planning()
        dt_ms = (time.perf_counter() - t0) * 1e3
        sim._step_control(sim_state.t, vehicle, trajectory)
        sim._apply_controls()
        if sim_state.finished:
            break                         # one scenario pass only

        if fam["marker"](planner) == before:
            continue                      # not a replan pass
        if warmed < warmup_replans:
            warmed += 1
            if warmed == warmup_replans:
                # same GC discipline as the RSTP bench: startup objects
                # out of generational scans, collector stays on
                gc.collect()
                gc.freeze()
            continue
        wall.append(dt_ms)
        splits.append(fam["split"](planner))
        if len(wall) >= replans:
            break
    gc.unfreeze()

    if not wall:
        raise RuntimeError(f"no replans observed for {planner_name} "
                           f"on {scenario}")
    wall = np.array(wall)
    return {
        "planner": planner_name,
        "scenario": scenario,
        "replans": len(wall),
        "cadence_s": cadence,
        "mean_ms": round(float(np.mean(wall)), 2),
        "p99_ms": round(float(np.percentile(wall, 99)), 2),
        "split": {k: round(float(np.mean([s[k] for s in splits])), 2)
                  for k in splits[0]} if splits else {},
    }


def bench_rstp_replan(iters=300, warmup=40):
    """One real receding-horizon RSTP replan tick, measured through the
    actual planner: corridor construction on host, then the fused
    single-dispatch device kernel (lateral iLQR solve -> bend/resample ->
    leader selection -> rampify -> velocity iLQR solve) with one device
    round trip per tick.  Scene: demo/parked_oncoming (3 objects)."""
    import gc
    np.random.seed(0)
    from tpl_tpu.simulation import SimStandalone

    sim = SimStandalone(app_id="benchrstp", scenario_path=SCENE)
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    planner = sim.planning_app.planners["path_vel_decomp_planner"]
    with planner.lock_shared():
        planner.shared.params.horizon = 100

    sh_env = sim.env_app.env
    for _ in range(warmup):
        sim.update()
    # Freeze startup objects out of generational GC scans (standard
    # practice for latency-sensitive services); GC itself stays enabled.
    gc.collect()
    gc.freeze()

    lats = []
    for _ in range(iters):
        sim.update()
        t0 = time.perf_counter()
        planner.update(sh_env)
        lats.append(time.perf_counter() - t0)
    lats = np.array(lats) * 1e3
    return float(np.percentile(lats, 99)), float(np.mean(lats))


def _device():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def leg_main(argv):
    """Child side: one measurement, one JSON line."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", required=True,
                    choices=["idm", "mpc", "poly", "rstp", "dp"])
    ap.add_argument("--planner", default="dp_lat_lon_planner")
    ap.add_argument("--scenario", default=SCENE)
    args = ap.parse_args(argv)

    import tpl_tpu  # noqa: F401  (x64, matmul precision, compile cache)
    if args.leg == "idm":
        out = {"rollouts_per_s": bench_idm_rollouts()}
    elif args.leg == "mpc":
        out = {"solves_per_s": bench_batched_mpc()}
    elif args.leg == "poly":
        p99_ms, mean_ms = bench_poly_sampling()
        out = {"p99_ms": p99_ms, "mean_ms": mean_ms}
    elif args.leg == "rstp":
        p99_ms, mean_ms = bench_rstp_replan()
        out = {"p99_ms": p99_ms, "mean_ms": mean_ms}
    else:
        out = bench_dp_replan(planner_name=args.planner,
                              scenario=args.scenario)
    out["device"] = _device()
    print(json.dumps(out))


def main():
    # latency numbers (RSTP p99) are host-dispatch sensitive; when
    # permitted, bias the bench above any background load (test sweeps,
    # builds) so recorded figures reflect the framework, not the box
    try:
        os.nice(-5)
    except (PermissionError, OSError):
        pass

    # contamination guard: latency figures are meaningless if the box is
    # busy — record the pre-bench load so a dirty run is self-evident
    try:
        loadavg_1m = os.getloadavg()[0]
    except OSError:
        loadavg_1m = -1.0
    if loadavg_1m > 1.0:
        print(f"WARNING: loadavg {loadavg_1m:.2f} > 1 before bench start; "
              "latency figures will be contaminated", file=sys.stderr)

    idm = run_leg("idm")
    if idm["device"]["platform"] != "gpu":
        raise SystemExit(f"bench: the default JAX device is "
                         f"{idm['device']['platform']!r}, not a GPU")
    mpc = run_leg("mpc")
    poly = run_leg("poly")
    rstp = run_leg("rstp")

    # DP planner family: per-replan latency + stage split, host leg
    # (the host CPU backend) and device leg (the default device)
    dp = {}
    for planner, key in (("dp_lat_lon_planner", "dp_replan"),
                         ("poly_lat_dp_lon_planner",
                          "poly_lat_dp_lon_replan"),
                         ("lattice_planner", "lattice_replan"),
                         ("dp_poly_planner", "dp_poly_replan"),
                         ("idm_sampling_planner", "idm_sampling_replan")):
        for suffix, host in (("", True), ("_device", False)):
            try:
                r = run_leg("dp", "--planner", planner, host=host)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                print(f"WARNING: {planner} {'host' if host else 'device'} "
                      f"leg failed: {e}", file=sys.stderr)
                continue
            dp[f"{key}{suffix}_mean_ms"] = r["mean_ms"]
            dp[f"{key}{suffix}_p99_ms"] = r["p99_ms"]
            dp[f"{key}{suffix}_split"] = r["split"]

    rollouts_per_s = idm["rollouts_per_s"]
    result = {
        "metric": "batched_rollouts_per_s_per_chip",
        "value": round(rollouts_per_s, 1),
        "unit": "rollouts/s",
        # target from BASELINE.json: >=10k batched rollouts/s/chip
        "vs_baseline": round(rollouts_per_s / 10000.0, 3),
        "mpc_solves_per_s_per_chip": round(mpc["solves_per_s"], 1),
        "rstp_replan_p99_ms": round(rstp["p99_ms"], 2),
        "rstp_replan_mean_ms": round(rstp["mean_ms"], 2),
        "poly_sampling_tick_p99_ms": round(poly["p99_ms"], 2),
        "poly_sampling_tick_mean_ms": round(poly["mean_ms"], 2),
        **dp,
        "replan_budget_ms": 20.0,
        # DP families replan at the production param sets' 0.5 s cadence
        # (reference default replan_time_step = 0.5), so a replan must
        # fit in its own period
        "dp_replan_budget_ms": 500.0,
        # per-family cadence budgets: each family's replan must fit in
        # its own production replan period (driver defaults)
        "family_budget_ms": {
            "dp_replan": 500.0,            # replan_time_step 0.5
            "poly_lat_dp_lon_replan": 500.0,
            "lattice_replan": 1000.0,      # reinit_time 1.0
            "dp_poly_replan": 1000.0,      # replan_time 1.0
            "idm_sampling_replan": 50.0,   # replan_time 0.05
        },
        "loadavg_1m_at_start": round(loadavg_1m, 2),
        "device": idm["device"],
    }
    if loadavg_1m > 1.0:
        result["load_contaminated"] = True
    print(json.dumps(result))


if __name__ == "__main__":
    if "--leg" in sys.argv:
        leg_main(sys.argv[1:])
    else:
        main()
