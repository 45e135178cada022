"""Fused single-dispatch replan kernel vs the host two-stage pipeline."""

import uuid

import numpy as np
import jax.numpy as jnp


def test_rampify_scan_matches_host():
    from tpl_tpu.ops.profile import rampify_profile
    from tpl_tpu.planning.path_vel_decomp.fused_replan import _rampify_scan

    rng = np.random.default_rng(0)
    H = 64
    lim_v = np.maximum(1.0, 10.0 + np.cumsum(rng.normal(0, 1.0, H)))
    lim_v[40:45] = 2.0

    host = rampify_profile(8.0, 0.3, lim_v, -2.5, 2.5, -1.5, 1.5, 1.0, 0.5)
    dev = np.asarray(_rampify_scan(
        jnp.float32(8.0), jnp.float32(0.3), jnp.asarray(lim_v, jnp.float32),
        jnp.int32(H), jnp.float32(-2.5), jnp.float32(2.5),
        jnp.float32(-1.5), jnp.float32(1.5), jnp.float32(1.0),
        jnp.float32(0.5)))

    np.testing.assert_allclose(dev[:, 0], host[:, 0], atol=1e-3)
    np.testing.assert_allclose(dev[:, 1], host[:, 1], atol=1e-3)


def test_device_projection_matches_host():
    from tpl_tpu.ops import geometry as geom
    from tpl_tpu.planning.path_vel_decomp.fused_replan import _project

    s = np.linspace(0, 20, 41)
    pts = np.stack([s, np.sin(0.3 * s)], -1)
    pos = np.array([[5.3, 2.0], [12.1, -3.0], [0.5, 0.1], [19.0, 0.4]])

    dev = _project(jnp.asarray(pts, jnp.float32), jnp.int32(len(pts)),
                   jnp.asarray(pos, jnp.float32))
    for i, p in enumerate(pos):
        h = geom.project(pts, p)
        assert abs(float(dev["sdist"][i]) - h.distance) < 1e-3, i
        assert abs(float(dev["arc"][i]) - h.arc_len) < 1e-3, i
        assert bool(dev["in_bounds"][i]) == h.in_bounds, i


def test_fused_matches_host_pipeline_closed_loop():
    """Run the sim; every tick, update a host-pipeline planner clone and a
    fused planner clone on the same shared environment and compare their
    trajectories."""
    import contextlib
    np.random.seed(0)
    from tpl_tpu.simulation import SimStandalone
    from tpl_tpu.planning.path_vel_decomp.path_vel_decomp_planner import (
        PathVelDecompPlanner)
    from tpl_tpu.util import Bundle

    app_id = uuid.uuid4().hex[:8]
    sim = SimStandalone(app_id=app_id, scenario_path="demo/parked_oncoming")
    with sim.core.sh_state.lock():
        ss = sim.core.sh_state.sim
        ss.settings.running = True
        ss.settings.use_real_time = False

    def make_planner(use_fused):
        shared = Bundle()

        @contextlib.contextmanager
        def lock():
            yield

        p = PathVelDecompPlanner(shared, lock)
        shared.params.use_fused = use_fused
        return p

    host = make_planner(False)
    fused = make_planner(True)

    sh_env = sim.env_app.env
    max_dxy = 0.0
    max_dv = 0.0
    compared = 0
    for _ in range(3):
        sim.update()
    for i in range(30):
        sim.update()
        if i % 3 != 0:
            continue
        th = host.update(sh_env)
        tf = fused.update(sh_env)
        n = min(len(th.x), len(tf.x))
        assert n > 100
        if i < 9:
            # cold-start solves do not converge within the iteration cap;
            # give both warm-start chains a few ticks to settle
            continue
        # the leader-selection and limit stages must agree exactly
        assert abs(host.velocity_optim.s_leader
                   - fused.velocity_optim.s_leader) < 0.1
        assert abs(host.velocity_optim.v_leader
                   - fused.velocity_optim.v_leader) < 0.1
        # compare the near field the controller consumes (50 m); in the far
        # tail (beyond the window end, where the map velocity collapses)
        # the host pipeline itself produces an oscillating solution whose
        # phase depends on resampler details
        n = min(n, 120)
        compared += 1
        dxy = np.hypot(np.asarray(th.x)[:n] - np.asarray(tf.x)[:n],
                       np.asarray(th.y)[:n] - np.asarray(tf.y)[:n])
        dv = np.abs(np.asarray(th.velocity)[:n]
                    - np.asarray(tf.velocity)[:n])
        max_dxy = max(max_dxy, float(dxy.max()))
        max_dv = max(max_dv, float(dv.max()))

    # the planned geometry must match tightly; velocities from the two
    # warm-start chains may differ by iteration-capped solver noise
    # (genopt-parity lookup derivatives vanish on-grid, leaving the
    # profile weakly determined between anchor points) but must stay
    # within a bounded band — structural bugs (wrong leader, broken
    # rampify) produce systematic >5 m/s errors
    assert compared >= 6
    assert max_dxy < 0.05, max_dxy
    assert max_dv < 3.5, max_dv
