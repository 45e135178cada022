"""
tplsim CLI: run closed-loop simulation scenarios headlessly.

Usage:
    python -m tpl_tpu.simulation.tplsim run --scenario demo/parked_oncoming \
        --headless --max-t 25

(reference: library/tpl/simulation/tplsim)
"""

import sys
import time
import argparse

import numpy as np


def run(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tpl_tpu.simulation import SimStandalone

    if args.seed is not None:
        np.random.seed(args.seed)

    sim = SimStandalone(app_id=args.app_id, scenario_path=args.scenario)

    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = not args.headless
        ss.settings.reload_if_finished = False
        ss.rule_checker.enable = True

    if args.planner:
        if args.planner not in sim.planning_app.planners:
            raise SystemExit(
                f"unknown planner {args.planner!r}; available: "
                f"{sorted(sim.planning_app.planners)}")
        with sim.planning_app.sh_planners.lock():
            sim.planning_app.sh_planners.active_planner = args.planner

    t_start = time.time()
    ticks = 0
    planner_runtimes = []

    # live code reloading, like the reference's minireload wrapper
    # (reference: library/tpl/simulation/tplsim:40-45)
    update = sim.update
    if not args.no_reload:
        from tpl_tpu.util.hotreload import WrappingReloader
        update = WrappingReloader(sim.update)

    while True:
        update()
        ticks += 1

        with sim.core.sh_state.lock():
            s = sim.core.sh_state.sim
            sim_t = s.t
            finished = s.finished
            n_viol = len(s.rule_checker.violations)

        with sim.planning_app.sh_planners.lock():
            planner_runtimes.append(sim.planning_app.sh_planners.runtime)

        if args.verbose and ticks % 100 == 0:
            print(f"t={sim_t:6.2f}s ticks={ticks} violations={n_viol} "
                  f"planner={planner_runtimes[-1]*1e3:.1f}ms", flush=True)

        if finished or (args.max_t and sim_t >= args.max_t):
            break
        if args.max_ticks and ticks >= args.max_ticks:
            break

    with sim.core.sh_state.lock():
        s = sim.core.sh_state.sim
        viols = s.rule_checker.violations

    rt = np.array(planner_runtimes[5:]) * 1e3
    print(f"\nscenario {args.scenario}: t={s.t:.2f}s ticks={ticks} "
          f"wall={time.time()-t_start:.1f}s finished={bool(finished)}")
    print(f"planner runtime ms: mean={rt.mean():.2f} std={rt.std():.2f} "
          f"p99={np.percentile(rt, 99):.2f} max={rt.max():.2f}")
    print(f"rule violations: {len(viols)}")
    for v in viols[:10]:
        print(" ", v)
    return 0 if len(viols) == 0 else 1


def attach(args):
    """Drive externally running apps over shared memory.
    (reference: tplsim attach)"""
    import os
    os.environ.setdefault("TPL_TPU_SHM", "1")
    from tpl_tpu.simulation.record import SimAttach

    sim = SimAttach(app_id=args.app_id, scenario_path=args.scenario)
    from tpl_tpu.util.hotreload import WrappingReloader
    update = WrappingReloader(sim.update)
    while True:
        update()


def replay(args):
    """Replay a recording into the sim store. (reference: tplsim replay)"""
    from tpl_tpu.simulation.record import SimReplay

    rep = SimReplay(app_id=args.app_id, recording_path=args.recording)
    while True:
        step = rep.update()
        if step >= len(rep.recording.sim_states) - 1:
            break


def main():
    parser = argparse.ArgumentParser(prog="tplsim")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run")
    p_run.add_argument("--scenario", default="default")
    p_run.add_argument("--planner", default=None,
                       help="active planner name (e.g. dp_lat_lon_planner)")
    p_run.add_argument("--app-id", default="tplsim")
    p_run.add_argument("--headless", action="store_true")
    p_run.add_argument("--cpu", action="store_true")
    p_run.add_argument("--max-t", type=float, default=None)
    p_run.add_argument("--max-ticks", type=int, default=None)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--verbose", action="store_true", default=True)
    p_run.add_argument("--no-reload", action="store_true",
                       help="disable live code reloading")

    p_att = sub.add_parser("attach")
    p_att.add_argument("--scenario", default="default")
    p_att.add_argument("--app-id", default="")

    p_rep = sub.add_parser("replay")
    p_rep.add_argument("--recording", required=True)
    p_rep.add_argument("--app-id", default="")

    args = parser.parse_args()
    if args.cmd == "run":
        sys.exit(run(args))
    elif args.cmd == "attach":
        attach(args)
    elif args.cmd == "replay":
        replay(args)


if __name__ == "__main__":
    main()
