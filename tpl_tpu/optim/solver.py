"""
Stateful solver wrapper around the jitted iLQR core.

Presents the same working surface as the reference's generated solver
classes (reference: library/tpl/optim/templates/optim.c:1654-1890 python
attributes: ``x``, ``u``, ``params``, ``u_min``/``u_max``,
``lagrange_multiplier``, ``barrier_weight``, ``lg_mult_limit``, ``horizon``,
``step``, ``max_iterations``, ``integrator_type``, and methods ``update()``,
``shift(n)``, ``dynamics(x, u, t, dt)``), so planner and controller drivers
read identically — but the solve itself is one jit-compiled XLA program.

Host buffers are numpy at fixed capacity; only the active horizon slice is
exposed. Array params are edge-padded to capacity so the clamped lerp
lookups behave exactly like the reference's variable-length arrays.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from tpl_tpu.optim import ilqr
from tpl_tpu.optim.ilqr import EULER, HEUN, RK4
from tpl_tpu.optim.problems import ArraySpec


class SolverParams:
    """Attribute-style access to the parameter buffers."""

    def __init__(self, spec):
        object.__setattr__(self, "_spec", spec)
        object.__setattr__(self, "_values", {})
        for name, s in spec.items():
            if hasattr(s, "capacity"):
                self._values[name] = np.full(s.capacity, s.default,
                                             dtype=np.float64)
            else:
                self._values[name] = float(s)

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        values = object.__getattribute__(self, "_values")
        spec = object.__getattribute__(self, "_spec")
        if name not in values:
            raise AttributeError(f"unknown param {name!r}")
        s = spec[name]
        if hasattr(s, "capacity"):
            arr = np.asarray(value, dtype=np.float64).reshape(-1)
            n = min(len(arr), s.capacity)
            buf = values[name]
            buf[:n] = arr[:n]
            if n > 0:
                buf[n:] = arr[n - 1]   # edge padding preserves clamp semantics
        else:
            values[name] = float(value)

    def merge(self, obj):
        """Copy matching attributes from a plain params object."""
        src = obj if isinstance(obj, dict) else vars(obj)
        for k, v in src.items():
            if k in self._values:
                setattr(self, k, v)

    def as_dict(self, dtype):
        out = {}
        for name, v in self._values.items():
            if isinstance(v, np.ndarray):
                out[name] = jnp.asarray(v, dtype)
            else:
                out[name] = jnp.asarray(v, dtype)
        return out


class Solver:
    """Drop-in iLQR solver instance for one problem configuration."""

    EULER = EULER
    HEUN = HEUN
    RK4 = RK4

    def __init__(self, problem, param_spec, horizon_max,
                 integrator_type=EULER, dtype=jnp.float32, device=None):
        self.problem = problem
        self.horizon_max = horizon_max
        self.dtype = dtype
        self._integrator = integrator_type
        self._update_fns = {}

        # device="cpu" pins the solve to the host CPU backend: a
        # single-instance iLQR solve is a latency-bound chain of hundreds
        # of dependent scan steps of tiny math.  Batched/vmapped solves
        # keep the default placement (device=None).  ``self.device`` is
        # the jax device the solves run on (None: default placement).
        self.device = (jax.local_devices(backend="cpu")[0]
                        if device == "cpu" else None)

        nx, nu = problem.nx, problem.nu
        nc = max(problem.nc, 1)

        H = horizon_max
        self._x = np.zeros((H + 1, nx))
        self._u = np.zeros((H, nu))
        self._lam = np.zeros((H, nc))
        self._mu_step = 0
        self._u_min = np.full((H, nu), -np.inf)
        self._u_max = np.full((H, nu), np.inf)

        self.params = SolverParams(param_spec)

        self.horizon = min(20, H)       # optim.c default T=20
        self.step = 0.05                # optim.c default dt
        self.max_iterations = 5
        self.max_lg_iterations = 1
        self.min_rel_cost_change = 1e-6
        self.barrier_weight = np.ones(nc)
        self._lg_mult_limit = np.full(nc, np.inf)

        self.traj_costs = 0.0
        self.runtime = 0.0

    # --- genopt-style attribute surface -------------------------------

    @property
    def T(self):
        return self.horizon

    @property
    def dt(self):
        return self.step

    @property
    def integrator_type(self):
        return self._integrator

    @integrator_type.setter
    def integrator_type(self, v):
        self._integrator = int(v)

    @property
    def x(self):
        return self._x[:self.horizon + 1]

    @x.setter
    def x(self, v):
        self._x[:self.horizon + 1] = v

    @property
    def u(self):
        return self._u[:self.horizon]

    @u.setter
    def u(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        self._u[:self.horizon] = v

    @property
    def u_min(self):
        return self._u_min[:self.horizon]

    @u_min.setter
    def u_min(self, v):
        self._u_min[:self.horizon] = v

    @property
    def u_max(self):
        return self._u_max[:self.horizon]

    @u_max.setter
    def u_max(self, v):
        self._u_max[:self.horizon] = v

    @property
    def lagrange_multiplier(self):
        return self._lam[:self.horizon]

    @property
    def lg_mult_limit(self):
        return self._lg_mult_limit

    @lg_mult_limit.setter
    def lg_mult_limit(self, v):
        self._lg_mult_limit[:] = v

    @lagrange_multiplier.setter
    def lagrange_multiplier(self, v):
        v = np.asarray(v, dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        self._lam[:self.horizon] = v

    # --- methods ------------------------------------------------------

    def shift(self, amount):
        """Warm-start shift (optim.c:1162-1177)."""
        amount = max(0, int(amount))
        T = self.horizon
        idx_x = np.minimum(np.arange(T + 1) + amount, T)
        self._x[:T + 1] = self._x[idx_x]
        idx_u = np.minimum(np.arange(T) + amount, T - 1)
        self._u[:T] = self._u[idx_u]
        self._lam[:T] = self._lam[idx_u]

    def dynamics(self, x, u, t, dt):
        """Single discrete integration step (host-side helper)."""
        xj = jnp.asarray(np.asarray(x, dtype=np.float64), self.dtype)
        uj = jnp.asarray(np.asarray(u, dtype=np.float64), self.dtype)
        p = self.params.as_dict(self.dtype)
        res = ilqr._integrate(self.problem.dynamics, xj, uj, t,
                              jnp.asarray(dt, self.dtype), p,
                              self._integrator)
        # np.array (not asarray): with matching dtypes asarray returns a
        # zero-copy READ-ONLY view of the device buffer; callers mutate
        # the result (dead-time compensation loop, mpc:172-177)
        return np.array(res, dtype=np.float64)

    def _get_rollforward_fn(self):
        """Jitted dead-time compensation rollout: integrate a state
        through a window of already-issued commands with one lax.scan
        program instead of per-step eager `dynamics()` calls (which cost
        ~25 ms of retracing each)."""
        key = ("rollforward", self._integrator)
        cached = self._update_fns.get(key)
        if cached is not None:
            return cached

        dyn = self.problem.dynamics
        integ = self._integrator
        nu = self.problem.nu

        def roll(x0, cmds, valid, slots, dt, p):
            u0 = jnp.zeros(nu, x0.dtype)

            def step(x, inp):
                cmd, ok = inp
                xs = x.at[slots].set(cmd)
                xn = ilqr._integrate(dyn, xs, u0, 0.0, dt, p, integ)
                return jnp.where(ok, xn, x), x

            xf, trace = jax.lax.scan(step, x0, (cmds, valid))
            return jnp.concatenate([trace, xf[None]], axis=0)

        fn = jax.jit(roll)
        self._update_fns[key] = fn
        return fn

    def rollforward_deadtime(self, x0, cmds, valid, idx_delta, idx_acc, dt):
        """Integrate ``x0`` through the command window ``cmds``
        ((n, 2) rows of (acc, steer); rows with ``valid`` False are
        pass-through padding at the front). Each step writes the issued
        command into the state's (acc, steer) slots and integrates one
        ``dt`` with the solver's own dynamics, so the compensation model
        matches the MPC prediction model exactly.

        Returns an (n+1, nx) float64 trace: row i = state after i steps.
        """
        fn = self._get_rollforward_fn()
        np_dtype = np.float32 if self.dtype == jnp.float32 else np.float64
        args = (np.asarray(x0, np_dtype),
                np.asarray(cmds, np_dtype),
                np.asarray(valid, bool),
                np.array([idx_acc, idx_delta]),
                np_dtype(dt),
                self.params.as_dict(self.dtype))
        if self.device is not None:
            with jax.default_device(self.device):
                res = fn(*args)
        else:
            res = fn(*args)
        return np.asarray(res, dtype=np.float64)

    def _get_update_fn(self):
        """Jitted update with PACKED inputs.

        Every jitted-arg leaf costs a host conversion + device_put per
        call, so the per-tick inputs travel as few merged arrays: the
        scalar params as one vector, array params stacked per capacity,
        u limits as one (H, nu, 2) array, and the config scalars as one
        f32 + one i32 vector.  The adapter unpacks them back into the
        core's params/cfg dicts inside the traced program.
        """
        key = self._integrator
        cached = self._update_fns.get(key)
        if cached is not None:
            return cached

        raw = ilqr.make_update_fn(self.problem, self.horizon_max,
                                  integrator=key, dtype=self.dtype,
                                  jit=False)
        spec = self.params._spec
        scal_names = tuple(n for n, s in spec.items()
                           if not hasattr(s, "capacity"))
        by_cap = {}
        for n, s in spec.items():
            if hasattr(s, "capacity"):
                by_cap.setdefault(s.capacity, []).append(n)
        cap_groups = tuple((c, tuple(ns)) for c, ns in sorted(by_cap.items()))

        def packed(state, u_lims, bw_lim, cfg_f, cfg_i, p_scal, *p_arrs):
            params = {}
            for (_, names), mat in zip(cap_groups, p_arrs):
                for j, n in enumerate(names):
                    params[n] = mat[:, j]
            for j, n in enumerate(scal_names):
                params[n] = p_scal[j]
            cfg = dict(
                u_min=u_lims[..., 0], u_max=u_lims[..., 1],
                barrier_weight=bw_lim[:, 0], lg_mult_limit=bw_lim[:, 1],
                dt=cfg_f[0], min_rel_cost_change=cfg_f[1],
                T=cfg_i[0], max_iterations=cfg_i[1],
                max_lg_iterations=cfg_i[2])
            return raw(state, state.x[0], params, cfg)

        entry = (jax.jit(packed), cap_groups, scal_names)
        self._update_fns[key] = entry
        return entry

    def update(self):
        if self.device is not None:
            with jax.default_device(self.device):
                return self._update_impl()
        return self._update_impl()

    def _update_impl(self):
        start = time.perf_counter()
        dtype = self.dtype
        np_dtype = np.float32 if dtype == jnp.float32 else np.float64

        fn, cap_groups, scal_names = self._get_update_fn()

        state = ilqr.SolverState(
            x=self._x.astype(np_dtype),
            u=self._u.astype(np_dtype),
            lam=self._lam.astype(np_dtype),
            mu_step=np.int32(self._mu_step))

        u_lims = np.stack(
            [np.nan_to_num(self._u_min, neginf=-1e30),
             np.nan_to_num(self._u_max, posinf=1e30)],
            axis=-1).astype(np_dtype)
        bw_lim = np.stack(
            [self.barrier_weight,
             np.nan_to_num(self._lg_mult_limit, posinf=1e30)],
            axis=-1).astype(np_dtype)
        cfg_f = np.array([self.step, self.min_rel_cost_change], np_dtype)
        cfg_i = np.array([self.horizon, self.max_iterations,
                          self.max_lg_iterations], np.int32)

        values = self.params._values
        p_scal = np.array([values[n] for n in scal_names], np_dtype)
        p_arrs = [np.stack([values[n] for n in names],
                           axis=-1).astype(np_dtype)
                  for _, names in cap_groups]

        new_state, info = fn(state, u_lims, bw_lim, cfg_f, cfg_i,
                             p_scal, *p_arrs)

        # one host round trip for all results
        x_h, u_h, lam_h, mu_h, costs_h = jax.device_get(
            (new_state.x, new_state.u, new_state.lam, new_state.mu_step,
             info["traj_costs"]))
        self._x[:] = np.asarray(x_h, dtype=np.float64)
        self._u[:] = np.asarray(u_h, dtype=np.float64)
        self._lam[:] = np.asarray(lam_h, dtype=np.float64)
        self._mu_step = int(mu_h)
        self.traj_costs = float(costs_h)
        self.runtime = (time.perf_counter() - start) * 1000.0
        return self
