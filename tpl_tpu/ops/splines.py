"""
Hermite boundary-value polynomials (cubic/quintic/septic) and the
free-end-position quartic used for longitudinal connections.

Re-designs the reference's CUDA ``PolyCubic``/``PolyQuintic``/``PolySeptic``/
``PolyQuartic`` (reference: library/include/tplcpp/poly_interp.cuh:7-112,
library/src/poly_interp.cu) as batched, jit-friendly coefficient solves:
coefficients come from a single constant matrix-vector product, so a whole
grid of candidate polynomials (e.g. the 21x13 lateral sampling of the
PolyLatPlanner) is one matmul.

Works with numpy and jax.numpy inputs alike.
"""

import numpy as np
import jax.numpy as jnp


def _xp(*arrays):
    for a in arrays:
        if isinstance(a, jnp.ndarray) and not isinstance(a, np.ndarray):
            return jnp
    return np


def _hermite_matrix(order):
    """Constraint matrix for monomial coefficients on u in [0, 1].

    Rows: derivatives 0..(order-1)/2 at u=0, then at u=1.
    """
    n = order + 1
    nd = n // 2
    m = np.zeros((n, n))
    for d in range(nd):
        # d-th derivative of u^k: k!/(k-d)! * u^(k-d)
        for k in range(d, n):
            fac = np.prod(np.arange(k - d + 1, k + 1), dtype=np.float64)
            if k == d:
                m[d, k] = fac          # at u=0 only k==d survives
            m[nd + d, k] = fac         # at u=1 all survive
    return m


_HERMITE_INV = {o: np.linalg.inv(_hermite_matrix(o)) for o in (3, 5, 7)}


class _HermitePoly:
    """Polynomial on [x0, x1] built from boundary derivatives.

    Stored in normalized coordinates u = (x - x0) / d with monomial
    coefficients ``c`` (shape (..., order+1)); derivative k in x is the
    u-derivative scaled by d^-k. Broadcasts over leading batch dims.
    """

    ORDER = None

    def __init__(self, x0, x1, c, d):
        self.x0 = x0
        self.x1 = x1
        self.c = c
        self.d = d

    def _init_from_bc(self, x0, x1, bc0, bc1):
        """bc0/bc1: lists of derivative values (value, d1, d2, ...) at ends."""
        xp = _xp(x0, x1, *bc0, *bc1)
        d = xp.asarray(x1) - xp.asarray(x0)
        # scale derivative k by d^k to move to normalized coordinates
        rows = []
        for k, v in enumerate(bc0):
            rows.append(xp.asarray(v) * d ** k)
        for k, v in enumerate(bc1):
            rows.append(xp.asarray(v) * d ** k)
        b = xp.stack(rows, axis=-1)                      # (..., order+1)
        inv = xp.asarray(_HERMITE_INV[self.ORDER])
        c = b @ inv.T                                    # (..., order+1)
        _HermitePoly.__init__(self, xp.asarray(x0), xp.asarray(x1), c, d)

    def _u(self, x):
        return (x - self.x0) / self.d

    def _eval(self, x, deriv):
        xp = _xp(x, self.c)
        u = self._u(x)
        n = self.ORDER + 1
        acc = 0.0
        # Horner in u for the deriv-th derivative
        for k in range(n - 1, deriv - 1, -1):
            fac = np.prod(np.arange(k - deriv + 1, k + 1), dtype=np.float64)
            acc = acc * u + self.c[..., k] * fac
        return acc / self.d ** deriv

    def f(self, x):
        return self._eval(x, 0)

    def df(self, x):
        return self._eval(x, 1)

    def ddf(self, x):
        return self._eval(x, 2)

    def dddf(self, x):
        return self._eval(x, 3)

    def df0to2(self, x):
        return self.f(x), self.df(x), self.ddf(x)

    def i1(self, x, ic0):
        """First antiderivative with integration constant ic0 at x0."""
        u = self._u(x)
        n = self.ORDER + 1
        acc = 0.0
        for k in range(n - 1, -1, -1):
            acc = acc * u + self.c[..., k] / (k + 1)
        return ic0 + acc * u * self.d

    def i2(self, x, ic0, ic1):
        """Second antiderivative; ic0 integrates into i1, ic1 offsets i2."""
        u = self._u(x)
        n = self.ORDER + 1
        acc = 0.0
        for k in range(n - 1, -1, -1):
            acc = acc * u + self.c[..., k] / ((k + 1) * (k + 2))
        return ic1 + ic0 * (x - self.x0) + acc * u * u * self.d * self.d


class PolyCubic(_HermitePoly):
    """Cubic Hermite: (x0, y0, dy0) -> (x1, y1, dy1).
    (reference: poly_interp.cuh:7-32)"""

    ORDER = 3

    def __init__(self, x0, y0, dy0, x1, y1, dy1):
        self._init_from_bc(x0, x1, (y0, dy0), (y1, dy1))


class PolyQuintic(_HermitePoly):
    """Quintic Hermite: position/velocity/acceleration at both ends.
    (reference: poly_interp.cuh:34-61)"""

    ORDER = 5

    def __init__(self, x0, y0, dy0, ddy0, x1, y1, dy1, ddy1):
        self._init_from_bc(x0, x1, (y0, dy0, ddy0), (y1, dy1, ddy1))


class PolySeptic(_HermitePoly):
    """Septic Hermite: up to jerk at both ends. (poly_interp.cuh:63-89)"""

    ORDER = 7

    def __init__(self, x0, y0, dy0, ddy0, dddy0, x1, y1, dy1, ddy1, dddy1):
        self._init_from_bc(x0, x1, (y0, dy0, ddy0, dddy0),
                           (y1, dy1, ddy1, dddy1))


# free-end-position quartic: 5 constraints
# f(0)=s, f'(0)=v, f''(0)=a, f'(T)=ve, f''(T)=ae  on normalized u in [0,1]
_M4 = np.zeros((5, 5))
_M4[0, 0] = 1.0                      # f(0)
_M4[1, 1] = 1.0                      # f'(0)
_M4[2, 2] = 2.0                      # f''(0)
for k in range(1, 5):                # f'(1)
    _M4[3, k] = k
for k in range(2, 5):                # f''(1)
    _M4[4, k] = k * (k - 1)
_M4_INV = np.linalg.inv(_M4)


class PolyQuartic:
    """Quartic with free end position for longitudinal connections.

    Matches the reference constructor signature
    ``PolyQuartic(ts, ss, vs, as, te, ve, ae)`` (poly_interp.cuh:91-112):
    start state fixed (pos, vel, acc), end constrains only (vel, acc).
    """

    def __init__(self, ts, ss, vs, acs, te, ve, ae):
        xp = _xp(ts, ss, vs, acs, te, ve, ae)
        self.x0 = xp.asarray(ts)
        d = xp.asarray(te) - self.x0
        self.d = d
        b = xp.stack([xp.asarray(ss),
                      xp.asarray(vs) * d,
                      xp.asarray(acs) * d * d,
                      xp.asarray(ve) * d,
                      xp.asarray(ae) * d * d], axis=-1)
        self.c = b @ xp.asarray(_M4_INV).T

    def _eval(self, x, deriv):
        u = (x - self.x0) / self.d
        acc = 0.0
        for k in range(4, deriv - 1, -1):
            fac = np.prod(np.arange(k - deriv + 1, k + 1), dtype=np.float64)
            acc = acc * u + self.c[..., k] * fac
        return acc / self.d ** deriv

    def f(self, x):
        return self._eval(x, 0)

    def df(self, x):
        return self._eval(x, 1)

    def ddf(self, x):
        return self._eval(x, 2)

    def dddf(self, x):
        return self._eval(x, 3)
