"""
Multi-process application entry points.

The reference deploys environment / planning / control as separate
processes over shared-memory stores (reference: library/tpl/application/
*_app.py main() loops + structstore). Here each main runs its app loop
against the mmap-backed ShmStore/ShmObject substrate; a simulation (or a
real-vehicle driver) attaches with :class:`tpl_tpu.simulation.SimAttach`.

Run e.g.:
    python -m tpl_tpu.application.mains env --app-id demo
    python -m tpl_tpu.application.mains planning --app-id demo
    python -m tpl_tpu.application.mains control --app-id demo

Only the planning app takes the accelerator.  The env and control apps
run on the host CPU backend (the tracking MPC is pinned to the host
anyway): a JAX process reserves most of a GPU's memory when it first
touches it, so a second process on the card would fail.
"""

import os
import sys
import time
import argparse

# the process substrate is shared memory in multi-process deployments
os.environ.setdefault("TPL_TPU_SHM", "1")


def _maybe_reload(update_fn):
    """Wrap an app update loop in the live code reloader, like the
    reference's minireload wrapper (reference: planning_app.py:131).
    Disable with TPL_TPU_NO_RELOAD=1."""
    if os.environ.get("TPL_TPU_NO_RELOAD"):
        return update_fn
    from tpl_tpu.util.hotreload import WrappingReloader
    return WrappingReloader(update_fn)


def _shared_env(app_id):
    # app stores use the bare app_id prefix (planning_app.py convention)
    from tpl_tpu.util.shm_store import ShmObject
    from tpl_tpu.environment import EnvironmentState
    return ShmObject(EnvironmentState(), f"/{app_id}tpl_env")


def env_main(app_id="", env_params=None, max_ticks=None):
    from tpl_tpu.application.environment_app import (
        EnvironmentApp, load_env_params)

    app = EnvironmentApp.__new__(EnvironmentApp)
    app.app_id = app_id
    app.last_time = -1.0
    app.env = _shared_env(app_id)
    with app.env.lock():
        app.env.storage = "default"
        load_env_params(app.env, env_params)
    from tpl_tpu.environment import TrackingModule, PredictionModule
    app.tracking_module = TrackingModule()
    app.prediction_module = PredictionModule()

    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        with app.env.lock():
            t = app.env.t
        update(t)
        time.sleep(0.001)
        ticks += 1


def planning_main(app_id="", planning_params=None, max_ticks=None):
    from tpl_tpu.application.planning_app import PlanningApp
    shared_env = _shared_env(app_id)
    shared_env.revalidate()
    app = PlanningApp(app_id, planning_params, shared_env=shared_env)
    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        shared_env.revalidate()
        update()
        ticks += 1


def control_main(app_id="", control_params=None, max_ticks=None):
    from tpl_tpu.application.control_app import ControlApp
    app = ControlApp(app_id, control_params)
    update = _maybe_reload(app.update)
    ticks = 0
    while max_ticks is None or ticks < max_ticks:
        update()
        time.sleep(0.001)
        ticks += 1


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("app", choices=["env", "planning", "control"])
    parser.add_argument("--app-id", default="")
    parser.add_argument("--params", default=None)
    parser.add_argument("--max-ticks", type=int, default=None)
    args = parser.parse_args()

    if args.app != "planning":
        # before the first JAX computation of this process; importing
        # this module already imported jax, so the env var alone is late
        import jax
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")

    if args.app == "env":
        env_main(args.app_id, args.params, args.max_ticks)
    elif args.app == "planning":
        planning_main(args.app_id, args.params, args.max_ticks)
    else:
        control_main(args.app_id, args.params, args.max_ticks)


if __name__ == "__main__":
    main()
