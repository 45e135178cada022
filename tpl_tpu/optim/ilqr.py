"""
Batched augmented-Lagrangian iLQR solver core.

This is the JAX replacement for the reference's ``genopt`` pipeline
(sympy -> generated C, reference: library/tpl/optim/genopt.py and
library/tpl/optim/templates/optim.c). Instead of code generation, the user
supplies ``dynamics`` / ``cost`` / ``constraints`` as JAX functions; the
engine differentiates them with autodiff and runs the full solve —
augmented-Lagrangian outer loop, iLQR backward pass, parallel 8-step decade
line search, mu-regularization schedule — as one jit-compiled XLA program.
``jax.vmap`` over the returned update function yields a batched solver
(thousands of independent MPC solves per chip).

Algorithmic parity notes (matching optim.c semantics exactly):

- AL penalty: cost += lam*c + (0 if c<0 and |lam|<1e-4 else w*c^2)
  (reference: genopt.py:73-90 augment_costs)
- multiplier update before each inner solve:
  lam <- clip(lam + w*c, 0, lam_max) (optim.c:1113-1131); the stored
  trajectory cost is *not* recomputed with the new multipliers, matching the
  reference's stale-cost comparison.
- backward pass: Euler jacobians fx = I + dt*df/dx regardless of the rollout
  integrator (genopt.py:gen_dynamics_routines computes the jacobian of
  x + dt*f) with mu added to Quu's diagonal; 1-D action solve returns zero
  gain when Quu <= 0 (optim.c:243-291 solve_action).
- control limits: clamped feedforward k with row-zeroed feedback K
  (optim.c:950-963), plus clamping in the forward rollout (optim.c:747-760).
- line search: alpha = 10^-i, i = 0..7, accept the largest improving alpha
  with finite, non-negative cost (optim.c:859-873, 836-857). All 8 rollouts
  evaluate in parallel on device (equivalent accept-first semantics).
- mu schedule: success -> mu_step-1, failure -> mu_step+1 (max 7);
  mu = 0 if mu_step == 0 else 10^(mu_step-1) (optim.c:989-999).
- termination: |dcost| / cost < min_rel_cost_change (optim.c:1001-1006);
  a failed line search therefore also terminates (dcost == 0).

The horizon capacity ``H`` is static; the active horizon ``T`` is a traced
scalar so changing path lengths never retrigger compilation. Steps beyond T
are frozen (state held, zero cost, zero gains).
"""

import dataclasses
from functools import partial
from typing import Callable, Any

import jax
import jax.numpy as jnp
import numpy as np


EULER = 0
HEUN = 1
RK4 = 2

# "how many mathematicians could you take in a fight?" (genopt.py:81)
_AL_ZERO = 1e-4


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static optimal-control problem definition.

    dynamics(x, u, t, dt, params) -> dx/dt           (continuous time)
    cost(x, u, t, dt, params) -> scalar              (per-step, unscaled)
    end_cost(x, t, dt, params) -> scalar
    constraints(x, u, t, dt, params) -> (nc,) array  (feasible iff <= 0)
    """

    name: str
    nx: int
    nu: int
    nc: int
    dynamics: Callable
    cost: Callable = None
    end_cost: Callable = None
    constraints: Callable = None


class SolverState:
    """Per-instance mutable solver state (a pytree)."""

    def __init__(self, x, u, lam, mu_step):
        self.x = x
        self.u = u
        self.lam = lam
        self.mu_step = mu_step

    def tree_flatten(self):
        return (self.x, self.u, self.lam, self.mu_step), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


jax.tree_util.register_pytree_node(
    SolverState,
    lambda s: s.tree_flatten(),
    SolverState.tree_unflatten)


def init_state(prob, horizon, dtype=jnp.float32):
    return SolverState(
        x=jnp.zeros((horizon + 1, prob.nx), dtype),
        u=jnp.zeros((horizon, prob.nu), dtype),
        lam=jnp.zeros((horizon, max(prob.nc, 1)), dtype),
        mu_step=jnp.zeros((), jnp.int32))


def _integrate(dynamics, x, u, t, dt, params, integrator):
    """Discrete step, matching optim.c:657-731 EULER/HEUN/RK4."""
    if integrator == EULER:
        return x + dt * dynamics(x, u, t, dt, params)
    if integrator == HEUN:
        k1 = dynamics(x, u, t, dt, params)
        k2 = dynamics(x + dt * k1, u, t, dt, params)
        return x + dt / 2.0 * (k1 + k2)
    if integrator == RK4:
        k1 = dynamics(x, u, t, dt, params)
        k2 = dynamics(x + dt / 2.0 * k1, u, t, dt, params)
        k3 = dynamics(x + dt / 2.0 * k2, u, t, dt, params)
        k4 = dynamics(x + dt * k3, u, t, dt, params)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    raise ValueError(f"unknown integrator {integrator}")


def make_update_fn(prob: Problem, horizon: int, integrator: int = EULER,
                   dtype=jnp.float32, jit: bool = True, unroll: int = 1):
    """Build the jit-compiled ``update`` for one problem/capacity.

    Returns ``update(state, x0, params, cfg) -> (state, info)`` where cfg is
    a dict with keys u_min, u_max (H, nu), barrier_weight, lg_mult_limit
    (nc,), dt, T, max_iterations, max_lg_iterations, min_rel_cost_change.
    """

    H = horizon
    nx, nu, nc = prob.nx, prob.nu, max(prob.nc, 1)
    has_con = prob.constraints is not None and prob.nc > 0

    def constraints(x, u, t, dt, params):
        if has_con:
            return jnp.asarray(prob.constraints(x, u, t, dt, params), dtype)
        return jnp.zeros((nc,), dtype)

    def aug_cost(x, u, t, dt, params, lam, w):
        c = jnp.asarray(prob.cost(x, u, t, dt, params), dtype)
        if has_con:
            g = constraints(x, u, t, dt, params)
            inactive = (g < 0.0) & (jnp.abs(lam) < _AL_ZERO)
            c = c + jnp.sum(g * lam)
            c = c + jnp.sum(jnp.where(inactive, 0.0, w * g * g))
        return c

    def end_cost(x, t, dt, params):
        if prob.end_cost is None:
            return jnp.zeros((), dtype)
        return jnp.asarray(prob.end_cost(x, t, dt, params), dtype)

    def step(x, u, t, dt, params):
        return _integrate(prob.dynamics, x, u, t, dt, params, integrator)

    ts = jnp.arange(H)

    # ---- derivative evaluation (vmapped over the horizon) ----

    def derivs_one(x, u, t, dt, params, lam, w):
        # Euler jacobians for the backward pass (genopt parity)
        jx = jax.jacfwd(lambda x_: prob.dynamics(x_, u, t, dt, params))(x)
        ju = jax.jacfwd(lambda u_: prob.dynamics(x, u_, t, dt, params))(u)
        fx = jnp.eye(nx, dtype=dtype) + dt * jnp.asarray(jx, dtype)
        fu = dt * jnp.asarray(ju, dtype)

        ca = lambda x_, u_: aug_cost(x_, u_, t, dt, params, lam, w)
        lx = jax.grad(ca, 0)(x, u)
        lu = jax.grad(ca, 1)(x, u)
        lxx = jax.jacfwd(jax.grad(ca, 0), 0)(x, u)
        luu = jax.jacfwd(jax.grad(ca, 1), 1)(x, u)
        lux = jax.jacfwd(jax.grad(ca, 1), 0)(x, u)
        return fx, fu, lx, lu, lxx, luu, lux

    derivs_all = jax.vmap(derivs_one, in_axes=(0, 0, 0, None, None, 0, None))

    # ---- action solve (optim.c:243-291) ----

    def solve_action(Quu, Qu, Qux, mu):
        if nu == 1:
            quu = Quu[0, 0]
            inv = jnp.where(quu > 0.0, -1.0 / (quu + mu), 0.0)
            return inv * Qu, inv * Qux
        if nu == 2:
            a = Quu[0, 0] + mu
            b = Quu[0, 1]
            d = Quu[1, 1] + mu
            det = a * d - b * b
            inv_det = -1.0 / det
            inv = jnp.array([[d, -b], [-b, a]], dtype) * inv_det
            return inv @ Qu, inv @ Qux
        reg = Quu + mu * jnp.eye(nu, dtype=dtype)
        sol = jnp.linalg.solve(reg, jnp.concatenate(
            [Qu[:, None], Qux], axis=1))
        return -sol[:, 0], -sol[:, 1:]

    # ---- rollouts ----

    def rollout(x0, us, dt, T, params, lam, w):
        """Open-loop rollout with current controls; frozen beyond T."""
        def f(x, inp):
            t, u = inp
            xn = step(x, u, t, dt, params)
            xn = jnp.where(t < T, xn, x)
            return xn, xn
        _, xs_tail = jax.lax.scan(f, x0, (ts, us), unroll=unroll)
        xs = jnp.concatenate([x0[None], xs_tail], axis=0)
        return xs

    def traj_cost(xs, us, dt, T, params, lam, w):
        cs = jax.vmap(
            lambda x, u, t, l: aug_cost(x, u, t, dt, params, l, w)
        )(xs[:-1], us, ts, lam)
        c = jnp.sum(jnp.where(ts < T, cs, 0.0))
        xT = jnp.take(xs, T, axis=0, mode="clip")
        return c + end_cost(xT, T, dt, params)

    def fb_rollout(alpha, x0, xs_ref, us_ref, ks, Ks, u_min, u_max,
                   dt, T, params, lam, w):
        """Closed-loop rollout with feedback (optim.c:733-793)."""
        def f(x, inp):
            t, xr, ur, k, K, lo, hi = inp
            u = ur + alpha * k + K @ (x - xr)
            u = jnp.clip(u, lo, hi)
            u = jnp.where(t < T, u, ur)
            xn = step(x, u, t, dt, params)
            xn = jnp.where(t < T, xn, x)
            return xn, (xn, u)
        _, (xs_tail, us) = jax.lax.scan(
            f, x0, (ts, xs_ref[:-1], us_ref, ks, Ks, u_min, u_max),
            unroll=unroll)
        xs = jnp.concatenate([x0[None], xs_tail], axis=0)
        return xs, us, traj_cost(xs, us, dt, T, params, lam, w)

    fb_rollout_v = jax.vmap(fb_rollout, in_axes=(0,) + (None,) * 12)

    alphas = jnp.asarray(10.0 ** -np.arange(8), dtype)

    # ---- backward pass ----

    def backward(xs, us, lam, w, u_min, u_max, dt, T, params, mu):
        fx, fu, lx, lu, lxx, luu, lux = derivs_all(
            xs[:-1], us, ts, dt, params, lam, w)

        xT = jnp.take(xs, T, axis=0, mode="clip")
        VxT = jax.grad(lambda x_: end_cost(x_, T, dt, params))(xT)
        VxxT = jax.hessian(lambda x_: end_cost(x_, T, dt, params))(xT)
        VxT = jnp.asarray(VxT, dtype)
        VxxT = jnp.asarray(VxxT, dtype).reshape(nx, nx)

        def bwd(carry, inp):
            Vx, Vxx = carry
            (t, fx_t, fu_t, lx_t, lu_t, lxx_t, luu_t, lux_t,
             u_t, lo, hi) = inp

            terminal = t == T - 1
            Vx_in = jnp.where(terminal, VxT, Vx)
            Vxx_in = jnp.where(terminal, VxxT, Vxx)

            Qx = lx_t + fx_t.T @ Vx_in
            Qu = lu_t + fu_t.T @ Vx_in
            Qxx = lxx_t + fx_t.T @ Vxx_in @ fx_t
            Quu = luu_t + fu_t.T @ Vxx_in @ fu_t
            Qux = lux_t + fu_t.T @ Vxx_in @ fx_t

            k, K = solve_action(Quu, Qu, Qux, mu)

            c = u_t + k
            over = c > hi
            under = c < lo
            k = jnp.where(over, hi - u_t, k)
            k = jnp.where(under, lo - u_t, k)
            K = jnp.where((over | under)[:, None], 0.0, K)

            KQux = K.T @ Qux
            Vxx_new = Qxx + KQux + KQux.T + K.T @ Quu @ K
            Vx_new = K.T @ Quu @ k + K.T @ Qu + Qux.T @ k + Qx

            active = t < T
            Vx_out = jnp.where(active, Vx_new, Vx)
            Vxx_out = jnp.where(active, Vxx_new, Vxx)
            k = jnp.where(active, k, 0.0)
            K = jnp.where(active, K, 0.0)
            return (Vx_out, Vxx_out), (k, K)

        init = (jnp.zeros(nx, dtype), jnp.zeros((nx, nx), dtype))
        _, (ks, Ks) = jax.lax.scan(
            bwd, init,
            (ts, fx, fu, lx, lu, lxx, luu, lux, us, u_min, u_max),
            reverse=True, unroll=unroll)
        return ks, Ks

    # ---- inner iLQR (optim.c:875-1008) ----

    def ilqr(x, u, lam, mu_step, traj_costs, cfg, params):
        u_min, u_max = cfg["u_min"], cfg["u_max"]
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], cfg["T"]

        def cond(c):
            _, _, _, _, it, done = c
            return (it < cfg["max_iterations"]) & ~done

        def body(c):
            x, u, traj_costs, mu_step, it, done = c
            mu = jnp.where(mu_step == 0, 0.0,
                           10.0 ** (mu_step.astype(dtype) - 1.0))

            ks, Ks = backward(x, u, lam, w, u_min, u_max, dt, T, params, mu)

            xs8, us8, costs8 = fb_rollout_v(
                alphas, x[0], x, u, ks, Ks, u_min, u_max, dt, T, params,
                lam, w)

            improving = ((costs8 < traj_costs) & jnp.isfinite(costs8)
                         & (costs8 >= 0.0))
            found = jnp.any(improving)
            idx = jnp.argmax(improving)

            x_new = jnp.where(found, xs8[idx], x)
            u_new = jnp.where(found, us8[idx], u)
            costs_new = jnp.where(found, costs8[idx], traj_costs)
            mu_step_new = jnp.where(
                found,
                jnp.maximum(0, mu_step - 1),
                jnp.minimum(mu_step + 1, 7))

            denom = jnp.where(costs_new == 0.0, 1.0, costs_new)
            rel = jnp.abs(costs_new - traj_costs) / denom
            done = rel < cfg["min_rel_cost_change"]
            return (x_new, u_new, costs_new, mu_step_new, it + 1, done)

        x, u, traj_costs, mu_step, it, _ = jax.lax.while_loop(
            cond, body,
            (x, u, traj_costs, mu_step, jnp.zeros((), jnp.int32),
             jnp.zeros((), bool)))
        return x, u, traj_costs, mu_step, it

    # ---- full update (optim.c:1091-1160) ----

    def update(state: SolverState, x0, params, cfg):
        x0 = jnp.asarray(x0, dtype)
        u = jnp.asarray(state.u, dtype)
        lam = jnp.asarray(state.lam, dtype)
        mu_step = state.mu_step
        w = cfg["barrier_weight"]
        dt, T = cfg["dt"], cfg["T"]

        # initial rollout with current controls and OLD multipliers
        xs = rollout(x0, u, dt, T, params, lam, w)
        traj_costs = traj_cost(xs, u, dt, T, params, lam, w)

        def lg_cond(c):
            _, _, _, _, _, lg_it = c
            return lg_it < cfg["max_lg_iterations"]

        def lg_body(c):
            x, u, lam, mu_step, traj_costs, lg_it = c
            # clipped multiplier update (optim.c:1113-1131)
            cs = jax.vmap(lambda x_, u_, t_: constraints(x_, u_, t_, dt,
                                                         params))(x[:-1], u, ts)
            lam_new = jnp.clip(lam + w[None, :] * cs, 0.0,
                               cfg["lg_mult_limit"][None, :])
            lam_new = jnp.where((ts < T)[:, None], lam_new, lam)
            x, u, traj_costs, mu_step, _ = ilqr(
                x, u, lam_new, mu_step, traj_costs, cfg, params)
            return (x, u, lam_new, mu_step, traj_costs, lg_it + 1)

        xs, u, lam, mu_step, traj_costs, _ = jax.lax.while_loop(
            lg_cond, lg_body,
            (xs, u, lam, mu_step, traj_costs, jnp.zeros((), jnp.int32)))

        new_state = SolverState(xs, u, lam, mu_step)
        info = {"traj_costs": traj_costs}
        return new_state, info

    if jit:
        update = jax.jit(update)
    return update
