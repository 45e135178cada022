#!/usr/bin/env python3
"""
Device time of one dp_lat_lon replan (env grid build + lat/lon DP solve)
at the code-default grid, and of the DP backward slices on their own,
from a jax.profiler trace.

    python tools/trace_latlon_replan.py [--out DIR] [--replans N]

Traces N replans, then N times the 8 non-terminal backward slices run
one by one (``solve.backward_step``, the slice the scan repeats).  Prints
the card's name and power limit and one JSON line: the replan's wall
time (median of 20, ``block_until_ready``), device time per replan by
program (HLO module) and by named scope (``latlon_backward``,
``latlon_forward``, other), and the 15 costliest kernels.  The trace
stays in DIR (default ``chiprun_out/trace_latlon``).
"""

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tpl_tpu  # noqa: E402,F401
from tpl_tpu.planning.dyn_prog import lat_lon_kernel as llk  # noqa: E402
from tpl_tpu.planning.dyn_prog.dp_environment import (  # noqa: E402
    DpEnvironment, DpEnvParams)

SCOPES = ("latlon_backward", "latlon_forward")


def make_programs():
    """The replan program as the driver dispatches it, on a straight
    200 m road with a stationary car ahead, and a thunk that runs the
    non-terminal backward slices of the same solve one by one."""
    ep = DpEnvParams()
    env = DpEnvironment()
    env.reinit_buffers(ep)
    rl = np.zeros((401, 9))
    rl[:, 0] = rl[:, 3] = np.arange(401) * 0.5
    rl[:, 5] = 10.0
    rl[:, 6:8] = 4.0
    env.set_ref_line(rl, 0.5)
    env.insert_geometry(
        [(np.array([[68., -2.], [72., -2.], [72., 0.], [68., 0.]]), t)
         for t in np.arange(10.0)], stationary=True)
    pp = llk.LatLonParams()
    spec = dict(t_steps=pp.t_steps, s_steps=pp.s_steps,
                ds_steps=pp.ds_steps, l_steps=pp.l_steps)
    replan, _, _ = llk.make_latlon_replan(spec)
    x0 = np.zeros(12, np.float32)
    x0[llk.C_DS] = 8.0
    inputs = env.device_inputs()
    packed, x0 = jnp.asarray(pp.packed()), jnp.asarray(x0)

    env.update()
    solve, _ = llk.make_latlon_solver(spec)
    tail = (env.grid.dist_map_lon, env.grid.ref_line, jnp.float32(0.5),
            pp.dynamic_dict())
    nodes, _ = solve(*tail, x0)

    def slices():
        return [solve.backward_step(nodes[i + 1], jnp.int32(i), *tail)
                for i in range(pp.t_steps - 2, 0, -1)]
    return spec, (lambda: replan(*inputs, packed, x0)), slices


def _stat(stats, *names):
    return next((str(stats[k]) for k in names if k in stats), "")


def device_ms(trace_dir, n):
    """Device time per replan on the GPU planes: by HLO module, by named
    scope, and the costliest kernels."""
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    by_module = collections.defaultdict(float)
    by_scope = collections.defaultdict(float)
    kernels = collections.defaultdict(float)
    keys = None
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                keys = keys or sorted(stats)
                blob = ev.name + " " + " ".join(
                    str(v) for v in stats.values())
                scope = next((s for s in SCOPES if s in blob), "other")
                module = _stat(stats, "hlo_module", "hlo_module_name")
                by_module[module] += ev.duration_ns
                by_scope[scope] += ev.duration_ns
                kernels[(module, scope, ev.name)] += ev.duration_ns
    ms = lambda d: {"|".join(k) if isinstance(k, tuple) else k:  # noqa: E731
                    round(v / 1e6 / n, 4)
                    for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    top = dict(list(ms(kernels).items())[:15])
    return dict(by_module=ms(by_module), by_scope=ms(by_scope),
                top_kernels=top, event_stat_keys=keys)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_latlon"))
    ap.add_argument("--replans", type=int, default=5)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    spec, one, slices = make_programs()
    for _ in range(3):
        jax.block_until_ready((one(), slices()))
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        jax.block_until_ready(one())
        ts.append(time.perf_counter() - t0)
    with jax.profiler.trace(args.out):
        for _ in range(args.replans):
            jax.block_until_ready(one())
        for _ in range(args.replans):
            jax.block_until_ready(slices())
    print(f"card: {card}")
    print(json.dumps(dict(
        grid=list(spec.values()), device=str(jax.devices()[0]),
        replan_wall_ms_median=1e3 * float(np.median(ts)),
        replan_wall_ms_min=1e3 * float(np.min(ts)),
        device_ms_per_replan=device_ms(args.out, args.replans))))


if __name__ == "__main__":
    main()
