"""
Batch-in-lanes iLQR: a throughput-oriented variant of the solver core
where the scenario batch lives in the LAST (minor) dimension.

``jax.vmap`` over :func:`tpl_tpu.optim.ilqr.make_update_fn` produces
(B, nx, nx)-shaped intermediates whose minor dimensions are tiny (e.g.
7x7). This module instead keeps every tensor shaped (..., B): per-step
matrices are (nx, nx, B), matrix products become batch-parallel einsums,
and derivatives are obtained with the basis-vector jvp/vjp trick
((nx + nu) forward passes instead of per-instance jacobians), so all
elementwise work vectorizes across the contiguous batch axis.

The problem's dynamics/cost/constraint functions are reused unchanged:
they index the state by position (x[0], x[1], ...), so feeding (nx, B)
arrays yields (nx, B) outputs. Array params are shared across the batch
(per-instance scalars can be passed as (B,) arrays).

Algorithm semantics match :mod:`tpl_tpu.optim.ilqr` (same AL update, line
search, mu schedule, termination).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.optim.ilqr import EULER, HEUN, RK4, _AL_ZERO


def make_batched_update_fn(prob, horizon, batch, integrator=EULER,
                           dtype=jnp.float32, jit=True):
    """Build a batched update: state arrays carry a trailing batch dim B.

    Returns ``update(x, u, lam, mu_step, x0, params, cfg)`` with
    x: (H+1, nx, B), u: (H, nu, B), lam: (H, nc, B), mu_step: (B,),
    x0: (nx, B). cfg as in the base engine but u_min/u_max: (H, nu)
    shared, scalars traced.
    """
    H = horizon
    B = batch
    nx, nu = prob.nx, prob.nu
    nc = max(prob.nc, 1)
    has_con = prob.constraints is not None and prob.nc > 0
    f32 = dtype

    def dyn(x, u, t, dt, params):
        return prob.dynamics(x, u, t, dt, params)

    def constraints(x, u, t, dt, params):
        if has_con:
            return prob.constraints(x, u, t, dt, params)
        return jnp.zeros((nc, B), f32)

    def aug_cost(x, u, t, dt, params, lam, w):
        c = prob.cost(x, u, t, dt, params)
        if has_con:
            g = constraints(x, u, t, dt, params)
            inactive = (g < 0.0) & (jnp.abs(lam) < _AL_ZERO)
            c = c + jnp.sum(g * lam, axis=0)
            c = c + jnp.sum(jnp.where(inactive, 0.0,
                                      w[:, None] * g * g), axis=0)
        return c

    def end_cost(x, t, dt, params):
        if prob.end_cost is None:
            return jnp.zeros(x.shape[-1:], f32)
        return prob.end_cost(x, t, dt, params)

    def step(x, u, t, dt, params):
        if integrator == EULER:
            return x + dt * dyn(x, u, t, dt, params)
        if integrator == HEUN:
            k1 = dyn(x, u, t, dt, params)
            k2 = dyn(x + dt * k1, u, t, dt, params)
            return x + dt / 2.0 * (k1 + k2)
        k1 = dyn(x, u, t, dt, params)
        k2 = dyn(x + dt / 2.0 * k1, u, t, dt, params)
        k3 = dyn(x + dt / 2.0 * k2, u, t, dt, params)
        k4 = dyn(x + dt * k3, u, t, dt, params)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    ts = jnp.arange(H)

    # ---- batched derivatives via basis-vector jvp / vjp ----

    def derivs_one_t(x, u, t, dt, params, lam, w):
        """x: (nx, B), u: (nu, B). Euler jacobians + cost derivatives,
        all with trailing batch dim."""
        f = lambda x_, u_: dyn(x_, u_, t, dt, params)

        def col_x(i):
            e = jnp.zeros((nx, 1), f32).at[i, 0].set(1.0)
            tangent = jnp.broadcast_to(e, (nx, B))
            _, jv = jax.jvp(lambda x_: f(x_, u), (x,), (tangent,))
            return jv                                   # (nx, B)

        def col_u(i):
            e = jnp.zeros((nu, 1), f32).at[i, 0].set(1.0)
            tangent = jnp.broadcast_to(e, (nu, B))
            _, jv = jax.jvp(lambda u_: f(x, u_), (u,), (tangent,))
            return jv

        jx = jnp.stack([col_x(i) for i in range(nx)], axis=1)  # (nx,nx,B)
        ju = jnp.stack([col_u(i) for i in range(nu)], axis=1)  # (nx,nu,B)
        eye = jnp.eye(nx, dtype=f32)[:, :, None]
        fx = eye + dt * jx
        fu = dt * ju

        ca = lambda x_, u_: jnp.sum(
            aug_cost(x_, u_, t, dt, params, lam, w))
        grad_xu = jax.grad(ca, argnums=(0, 1))
        lx, lu = grad_xu(x, u)                          # (nx,B), (nu,B)

        def hess_col_x(i):
            e = jnp.zeros((nx, 1), f32).at[i, 0].set(1.0)
            tangent = jnp.broadcast_to(e, (nx, B))
            _, (hx, hu) = jax.jvp(lambda x_: grad_xu(x_, u), (x,),
                                  (tangent,))
            return hx, hu                               # d(lx)/dx_i, d(lu)/dx_i

        def hess_col_u(i):
            e = jnp.zeros((nu, 1), f32).at[i, 0].set(1.0)
            tangent = jnp.broadcast_to(e, (nu, B))
            _, (hx, hu) = jax.jvp(lambda u_: grad_xu(x, u_), (u,),
                                  (tangent,))
            return hx, hu

        hx_cols = [hess_col_x(i) for i in range(nx)]
        hu_cols = [hess_col_u(i) for i in range(nu)]
        lxx = jnp.stack([h[0] for h in hx_cols], axis=1)  # (nx, nx, B)
        lux = jnp.stack([h[1] for h in hx_cols], axis=1)  # (nu, nx, B)
        luu = jnp.stack([h[1] for h in hu_cols], axis=1)  # (nu, nu, B)
        return fx, fu, lx, lu, lxx, luu, lux

    derivs_scan = derivs_one_t

    # ---- lane-parallel linear algebra ----

    # Broadcast-multiply-sum instead of einsum/dot_general: contraction
    # dims are tiny (<= nx) while B fills the lanes, so elementwise VPU ops
    # beat a badly tiled batched matmul.

    def mv(A, v):
        """(m, n, B) @ (n, B) -> (m, B)"""
        return jnp.sum(A * v[None, :, :], axis=1)

    def mTv(A, v):
        return jnp.sum(A * v[:, None, :], axis=0)

    def mm(A, C):
        """(m, n, B) @ (n, k, B) -> (m, k, B)"""
        return jnp.sum(A[:, :, None, :] * C[None, :, :, :], axis=1)

    def mTm(A, C):
        return jnp.sum(A[:, :, None, :] * C[:, None, :, :], axis=0)

    def solve_action(Quu, Qu, Qux, mu):
        """mu: (B,)"""
        if nu == 1:
            quu = Quu[0, 0]
            inv = jnp.where(quu > 0.0, -1.0 / (quu + mu), 0.0)
            return inv[None, :] * Qu, inv[None, None, :] * Qux
        if nu == 2:
            a = Quu[0, 0] + mu
            b = Quu[0, 1]
            d = Quu[1, 1] + mu
            det = a * d - b * b
            inv_det = -1.0 / det
            k0 = (d * Qu[0] - b * Qu[1]) * inv_det
            k1 = (-b * Qu[0] + a * Qu[1]) * inv_det
            K0 = (d * Qux[0] - b * Qux[1]) * inv_det[None, :]
            K1 = (-b * Qux[0] + a * Qux[1]) * inv_det[None, :]
            return jnp.stack([k0, k1]), jnp.stack([K0, K1])
        # general case (matches tpl_tpu.optim.ilqr.solve_action): batched
        # LAPACK-style solve with the batch in the leading dim — nu > 2 is
        # off the reference's analytic path, so exact lane layout matters
        # less than correctness here
        reg = jnp.moveaxis(Quu, -1, 0) \
            + mu[:, None, None] * jnp.eye(nu, dtype=f32)
        rhs = jnp.moveaxis(
            jnp.concatenate([Qu[:, None, :], Qux], axis=1), -1, 0)
        sol = -jnp.moveaxis(jnp.linalg.solve(reg, rhs), 0, -1)
        return sol[:, 0, :], sol[:, 1:, :]

    # ---- rollouts ----

    def rollout(x0, us, dt, T, params, lam, w):
        def f(x, inp):
            t, u = inp
            xn = step(x, u, t, dt, params)
            xn = jnp.where(t < T, xn, x)
            return xn, xn
        _, xs_tail = jax.lax.scan(f, x0, (ts, us))
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    def traj_cost(xs, us, dt, T, params, lam, w):
        def c_t(x, u, t, l):
            return aug_cost(x, u, t, dt, params, l, w)
        cs = jax.vmap(c_t, in_axes=(0, 0, 0, 0))(xs[:-1], us, ts, lam)
        c = jnp.sum(jnp.where((ts < T)[:, None], cs, 0.0), axis=0)
        xT = jnp.take(xs, T, axis=0, mode="clip")
        return c + end_cost(xT, T, dt, params)

    def fb_rollout(alpha, x0, xs_ref, us_ref, ks, Ks, u_min, u_max,
                   dt, T, params, lam, w):
        """alpha: (A,) evaluated jointly by folding A into the lane dim."""
        A = alpha.shape[0]

        def rep(z):
            # (..., B) -> (..., A*B)
            return jnp.tile(z, (1,) * (z.ndim - 1) + (A,))

        alpha_b = jnp.repeat(alpha, B)                  # (A*B,)
        x = rep(x0)

        def f(x, inp):
            t, xr, ur, k, K, lo, hi = inp
            xr_b = rep(xr)
            ur_b = rep(ur)
            k_b = rep(k)
            K_b = rep(K)
            u = ur_b + alpha_b[None, :] * k_b \
                + jnp.sum(K_b * (x - xr_b)[None, :, :], axis=1)
            u = jnp.clip(u, lo[:, None], hi[:, None])
            u = jnp.where(t < T, u, ur_b)
            xn = step(x, u, t, dt, params)
            xn = jnp.where(t < T, xn, x)
            return xn, (xn, u)

        _, (xs_tail, us) = jax.lax.scan(
            f, x, (ts, xs_ref[:-1], us_ref, ks, Ks, u_min, u_max))
        xs = jnp.concatenate([x[None], xs_tail], axis=0)

        def c_t(x_, u_, t, l):
            return aug_cost(x_, u_, t, dt, params, rep(l), w)
        cs = jax.vmap(c_t, in_axes=(0, 0, 0, 0))(xs[:-1], us, ts, lam)
        c = jnp.sum(jnp.where((ts < T)[:, None], cs, 0.0), axis=0)
        xT = jnp.take(xs, T, axis=0, mode="clip")
        c = c + end_cost(xT, T, dt, params)
        # reshape to (A, ..., B)
        return (xs.reshape(H + 1, nx, A, B),
                us.reshape(H, nu, A, B),
                c.reshape(A, B))

    alphas = jnp.asarray(10.0 ** -np.arange(8), f32)

    # ---- backward pass ----

    def backward(xs, us, lam, w, u_min, u_max, dt, T, params, mu):
        def d_t(x, u, t, l):
            return derivs_scan(x, u, t, dt, params, l, w)
        fx, fu, lx, lu, lxx, luu, lux = jax.vmap(
            d_t, in_axes=(0, 0, 0, 0))(xs[:-1], us, ts, lam)

        xT = jnp.take(xs, T, axis=0, mode="clip")
        ec = lambda x_: jnp.sum(end_cost(x_, T, dt, params))
        VxT = jax.grad(ec)(xT)                          # (nx, B)

        def vxx_col(i):
            e = jnp.zeros((nx, 1), f32).at[i, 0].set(1.0)
            tangent = jnp.broadcast_to(e, (nx, B))
            _, hv = jax.jvp(jax.grad(ec), (xT,), (tangent,))
            return hv
        VxxT = jnp.stack([vxx_col(i) for i in range(nx)], axis=1)

        def bwd(carry, inp):
            Vx, Vxx = carry
            (t, fx_t, fu_t, lx_t, lu_t, lxx_t, luu_t, lux_t,
             u_t, lo, hi) = inp

            terminal = t == T - 1
            Vx_in = jnp.where(terminal, VxT, Vx)
            Vxx_in = jnp.where(terminal, VxxT, Vxx)

            Qx = lx_t + mTv(fx_t, Vx_in)
            Qu = lu_t + mTv(fu_t, Vx_in)
            Vfx = mm(Vxx_in, fx_t)
            Qxx = lxx_t + mTm(fx_t, Vfx)
            Quu = luu_t + mTm(fu_t, mm(Vxx_in, fu_t))
            Qux = lux_t + mTm(fu_t, Vfx)

            k, K = solve_action(Quu, Qu, Qux, mu)

            c = u_t + k
            over = c > hi[:, None]
            under = c < lo[:, None]
            k = jnp.where(over, hi[:, None] - u_t, k)
            k = jnp.where(under, lo[:, None] - u_t, k)
            # K: (nu, nx, B); zero rows where clamped: mask (nu, 1, B)
            K = jnp.where((over | under)[:, None, :], 0.0, K)

            KQux = mTm(K, Qux)
            Vxx_new = Qxx + KQux + KQux.swapaxes(0, 1) + mTm(K, mm(Quu, K))
            Vx_new = mTv(K, mv(Quu, k)) + mTv(K, Qu) + mTv(Qux, k) + Qx

            active = t < T
            Vx_out = jnp.where(active, Vx_new, Vx)
            Vxx_out = jnp.where(active, Vxx_new, Vxx)
            k = jnp.where(active, k, 0.0)
            K = jnp.where(active, K, 0.0)
            return (Vx_out, Vxx_out), (k, K)

        init = (jnp.zeros((nx, B), f32), jnp.zeros((nx, nx, B), f32))
        _, (ks, Ks) = jax.lax.scan(
            bwd, init,
            (ts, fx, fu, lx, lu, lxx, luu, lux, us, u_min, u_max),
            reverse=True)
        return ks, Ks

    # ---- solve ----

    def update(x, u, lam, mu_step, x0, params, cfg):
        u_min, u_max = cfg["u_min"], cfg["u_max"]
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], cfg["T"]

        xs = rollout(x0, u, dt, T, params, lam, w)
        traj_costs = traj_cost(xs, u, dt, T, params, lam, w)

        def lg_body(c, _):
            x, u, lam, mu_step, traj_costs = c
            cs = jax.vmap(
                lambda x_, u_, t_: constraints(x_, u_, t_, dt, params)
            )(x[:-1], u, ts)
            lam_new = jnp.clip(cs * w[None, :, None] + lam, 0.0,
                               cfg["lg_mult_limit"][None, :, None])
            lam_new = jnp.where((ts < T)[:, None, None], lam_new, lam)

            def cond(cc):
                _, _, _, _, it, done = cc
                return (it < cfg["max_iterations"]) & ~jnp.all(done)

            def body(cc):
                x, u, traj_costs, mu_step, it, done = cc
                mu = jnp.where(mu_step == 0, 0.0,
                               10.0 ** (mu_step.astype(f32) - 1.0))
                ks, Ks = backward(x, u, lam_new, w, u_min, u_max, dt, T,
                                  params, mu)
                xs8, us8, costs8 = fb_rollout(
                    alphas, x[0], x, u, ks, Ks, u_min, u_max, dt, T,
                    params, lam_new, w)
                improving = ((costs8 < traj_costs[None])
                             & jnp.isfinite(costs8) & (costs8 >= 0.0))
                found = jnp.any(improving, axis=0)          # (B,)
                idx = jnp.argmax(improving, axis=0)         # (B,)

                xi = jnp.take_along_axis(
                    xs8, idx[None, None, None, :], axis=2)[:, :, 0, :]
                ui = jnp.take_along_axis(
                    us8, idx[None, None, None, :], axis=2)[:, :, 0, :]
                ci = jnp.take_along_axis(costs8, idx[None, :],
                                         axis=0)[0]

                sel = found & ~done
                x_new = jnp.where(sel[None, None, :], xi, x)
                u_new = jnp.where(sel[None, None, :], ui, u)
                costs_new = jnp.where(sel, ci, traj_costs)
                mu_step_new = jnp.where(done, mu_step, jnp.where(
                    found, jnp.maximum(0, mu_step - 1),
                    jnp.minimum(mu_step + 1, 7)))

                denom = jnp.where(costs_new == 0.0, 1.0, costs_new)
                rel = jnp.abs(costs_new - traj_costs) / denom
                done = done | (rel < cfg["min_rel_cost_change"])
                return (x_new, u_new, costs_new, mu_step_new, it + 1,
                        done)

            x, u, traj_costs, mu_step, _, _ = jax.lax.while_loop(
                cond, body,
                (x, u, traj_costs, mu_step, jnp.zeros((), jnp.int32),
                 jnp.zeros((B,), bool)))
            return (x, u, lam_new, mu_step, traj_costs), None

        (xs, u, lam, mu_step, traj_costs), _ = jax.lax.scan(
            lg_body, (xs, u, lam, mu_step, traj_costs),
            None, length=1)

        return xs, u, lam, mu_step, traj_costs

    if jit:
        update = jax.jit(update)
    return update
