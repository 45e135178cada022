"""
Scaling-efficiency bench: batched MPC solves sharded over a device mesh.

Measures weak scaling (fixed per-device batch) of the lanes-batched
AL-iLQR tracking-MPC solve over a 1-D "dp" scenario mesh at increasing
device counts, and reports efficiency(N) = tput(N) / (N * tput(1)).
This is the BASELINE.md "≥80% scaling efficiency" measurement; the
workload is embarrassingly parallel over scenarios, so efficiency loss
comes only from dispatch overhead and any collectives XLA inserts.

Configs (BASELINE.md):
  1 card:    python3 tools/bench_scaling.py --devices 1
  1 host:    python3 tools/bench_scaling.py            (uses all local cards)
  N hosts:   run on every host with
             python3 tools/bench_scaling.py --coordinator HOST0:1234 \
                 --num-processes N --process-id I
Demo without accelerator hardware (8 virtual devices, structure only -- the
devices share physical cores, so efficiency numbers are not meaningful):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python3 tools/bench_scaling.py

Prints one JSON line:
  {"devices": [...], "solves_per_s": [...], "efficiency": [...], ...}
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def bench_one(n_dev, per_dev_batch, horizon, iters, max_iterations):
    import __graft_entry__ as ge
    from jax import shard_map
    from tpl_tpu.optim import batched, ilqr
    from tpl_tpu.parallel import scenario_mesh

    B = n_dev * per_dev_batch
    mesh = scenario_mesh(n_dev)

    _update, state, x0, params, cfg = ge._mpc_setup(
        horizon=horizon, max_iterations=max_iterations)
    prob, _spec = ge._mpc_problem()
    # per-device solver over the LOCAL batch, mapped over the mesh:
    # scenarios are independent, so shard_map guarantees a collective-free
    # program (auto-sharding of the while_loop inserts all-gathers)
    lupdate = batched.make_batched_update_fn(
        prob, horizon, per_dev_batch, integrator=ilqr.HEUN, jit=False)

    lastP = lambda nd: P(*([None] * (nd - 1) + ["dp"]))
    in_specs = (lastP(3), lastP(3), lastP(3), P("dp"), lastP(2))
    out_specs = (lastP(3), lastP(3), lastP(3), P("dp"), P("dp"))
    solve = jax.jit(shard_map(
        lambda x, u, lam, mu, x0_: lupdate(x, u, lam, mu, x0_, params, cfg),
        mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False))

    # lanes layout: batch in the LAST dim, sharded over the dp axis
    def shard_last(a):
        return jax.device_put(a, NamedSharding(mesh, lastP(a.ndim)))

    bx0 = (jnp.broadcast_to(x0, (B,) + x0.shape)
           + 0.01 * jnp.arange(B, dtype=x0.dtype)[:, None])
    xl = shard_last(jnp.broadcast_to(
        state.x[:, :, None], state.x.shape + (B,)))
    ul = shard_last(jnp.broadcast_to(
        state.u[:, :, None], state.u.shape + (B,)))
    laml = shard_last(jnp.broadcast_to(
        state.lam[:, :, None], state.lam.shape + (B,)))
    mus = shard_last(jnp.zeros((B,), jnp.int32))
    x0l = shard_last(bx0.T)

    out = solve(xl, ul, laml, mus, x0l)
    jax.block_until_ready(out[0])

    t0 = time.perf_counter()
    for _ in range(iters):
        out = solve(xl, ul, laml, mus, x0l)
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    return B * iters / dt


def compare_distributed(args):
    """1-process vs 2-process ``jax.distributed`` at IDENTICAL per-device
    shapes, per-process efficiency derived in-run.

    Layout on one box: each process hosts ``dev_per_proc`` virtual CPU
    devices, so the 1-proc baseline uses dev_per_proc devices and the
    2-proc run uses 2 x dev_per_proc — per-device batch, horizon, and
    iteration counts are identical, and (with dev_per_proc chosen so all
    devices together <= physical cores) each virtual device maps to its
    own core in both configs.  efficiency = tput(2 proc) / (2 x
    tput(1 proc)): what adding a second process over Gloo-style
    collectives costs at fixed per-process work.

    ``--batch-sweep`` sweeps per_device_batch across an operating curve:
    the process-boundary cost is fixed per step, so efficiency rises
    with batch; the curve shows where it crosses the 0.80 target.

    Controls (round-5 hardening): every process is CPU-PINNED with
    taskset — the 1-proc baseline to cores [0, dev_per_proc), each
    2-proc rank to its own disjoint core set — so the scheduler cannot
    migrate ranks onto shared cores mid-run; each batch point runs
    ``--reps`` independent 1-proc/2-proc pairs and reports the
    per-point min/median spread alongside the median efficiency.
    """
    import shutil
    import socket
    import subprocess

    dev_per_proc = max(1, (os.cpu_count() or 4) // 2)
    base_env = dict(os.environ,
                    JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count="
                              f"{dev_per_proc}")
    me = os.path.abspath(__file__)

    have_taskset = shutil.which("taskset") is not None

    def pin(core_lo, core_hi):
        """taskset prefix pinning to cores [core_lo, core_hi)."""
        if not have_taskset:
            return []
        return ["taskset", "-c",
                ",".join(str(c) for c in range(core_lo, core_hi))]

    def parse(stdout, stderr):
        for line in reversed(stdout.strip().splitlines()):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
        raise RuntimeError("no JSON line in sub-bench output; stderr:\n"
                           + stderr[-2000:])

    def run_pair(per_device_batch):
        common = ["--per-device-batch", str(per_device_batch),
                  "--horizon", str(args.horizon),
                  "--iters", str(args.iters),
                  "--max-iterations", str(args.max_iterations)]

        # 1-proc baseline: pinned to the SAME number of cores as one
        # 2-proc rank, for a fair per-process denominator
        r1 = subprocess.run(
            pin(0, dev_per_proc)
            + [sys.executable, me, "--devices", str(dev_per_proc)]
            + common,
            env=base_env, capture_output=True, text=True, timeout=1800)
        if r1.returncode != 0:
            raise RuntimeError(
                f"1-proc sub-bench failed (rc={r1.returncode}); stderr:\n"
                + r1.stderr[-2000:])
        one = parse(r1.stdout, r1.stderr)

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        coord = f"localhost:{port}"
        procs = [subprocess.Popen(
            pin(i * dev_per_proc, (i + 1) * dev_per_proc)
            + [sys.executable, me, "--coordinator", coord,
               "--num-processes", "2", "--process-id", str(i),
               "--devices", str(2 * dev_per_proc)] + common,
            env=base_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i in range(2)]
        try:
            outs = [p.communicate(timeout=1800) for p in procs]
        finally:
            # a TimeoutExpired (or rank-0 crash) must not orphan siblings
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(
                    f"2-proc sub-bench rank {i} failed "
                    f"(rc={p.returncode}); stderr:\n" + err[-2000:])
        two = parse(*outs[0])
        return one["solves_per_s"][0], two["solves_per_s"][0]

    batches = args.batch_sweep or [args.per_device_batch]
    rows = []
    for b in batches:
        t1s, t2s, effs = [], [], []
        for rep in range(args.reps):
            t1, t2 = run_pair(b)
            t1s.append(t1)
            t2s.append(t2)
            effs.append(t2 / (2.0 * t1))
            print(f"# batch {b} rep {rep}: eff {effs[-1]:.3f}",
                  file=sys.stderr)
        rows.append({
            "per_device_batch": b,
            "reps": args.reps,
            "solves_per_s_1proc": round(float(np.median(t1s)), 1),
            "solves_per_s_1proc_min": round(float(np.min(t1s)), 1),
            "solves_per_s_2proc": round(float(np.median(t2s)), 1),
            "solves_per_s_2proc_min": round(float(np.min(t2s)), 1),
            "efficiency_2proc": round(float(np.median(effs)), 3),
            "efficiency_2proc_min": round(float(np.min(effs)), 3),
            "efficiency_2proc_max": round(float(np.max(effs)), 3),
        })

    best = max(rows, key=lambda r: r["efficiency_2proc"])
    out = {
        "metric": "distributed_per_process_efficiency",
        "dev_per_process": dev_per_proc,
        "platform": "cpu-virtual",
        "cpu_pinned": have_taskset,
        "curve": rows,
        "best_efficiency_2proc": best["efficiency_2proc"],
        "best_per_device_batch": best["per_device_batch"],
    }
    # single-point runs keep the flat round-3 schema for compatibility
    if len(rows) == 1:
        out.update(rows[0])
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--max-iterations", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (default: 1,2,4,..,all)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port for multi-host jax.distributed")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--compare-distributed", action="store_true",
                    help="orchestrate a 1-proc vs 2-proc jax.distributed "
                         "comparison at identical per-device shapes")
    ap.add_argument("--batch-sweep", type=int, nargs="*", default=None,
                    help="with --compare-distributed: sweep per-device "
                         "batch sizes and report the efficiency curve")
    ap.add_argument("--reps", type=int, default=3,
                    help="with --compare-distributed: independent "
                         "repetitions per batch point (min/median "
                         "reported)")
    args = ap.parse_args()

    if args.compare_distributed:
        compare_distributed(args)
        return

    from tpl_tpu.parallel import init_distributed
    init_distributed(args.coordinator, args.num_processes, args.process_id)

    n_all = len(jax.devices())
    counts = args.devices
    if jax.process_count() > 1:
        # multi-host: a mesh smaller than the pod would leave some
        # processes without addressable devices, so each invocation
        # measures exactly one point — the full pod. Efficiency across
        # scales is computed offline from the per-invocation numbers
        # (BASELINE.md configs: 1 chip, 1 host, N hosts).
        counts = [n_all]
    elif not counts:
        counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                  if n <= n_all]
        if counts[-1] != n_all:
            counts.append(n_all)

    tputs = [bench_one(n, args.per_device_batch, args.horizon,
                       args.iters, args.max_iterations) for n in counts]
    result = {
        "metric": "mpc_scaling_efficiency",
        "devices": counts,
        "per_device_batch": args.per_device_batch,
        "solves_per_s": [round(t, 1) for t in tputs],
        "platform": jax.devices()[0].platform,
        "n_processes": jax.process_count(),
    }
    if counts[0] == 1:
        base = tputs[0]
        result["efficiency"] = [round(t / (n * base), 3)
                                for n, t in zip(counts, tputs)]
    # without a 1-device point in this run there is no in-run baseline;
    # report raw throughputs only
    if jax.process_index() == 0:
        print(json.dumps(result))


if __name__ == "__main__":
    main()
