"""
The decision rule the DP kernels share (lat_lon_kernel, lon_kernel):
sample grids that round alike on every backend, and the
lexicographic (constraint, cost) argmin over the sampled actions.
"""

import numpy as np
import jax
import jax.numpy as jnp


def unit_grid(n):
    """k / (n - 1) for k = 0 .. n-1 as f32 constants, each rounded once
    from the exact quotient.  Sample grids built from these (and steps
    built with :func:`recip`) are bit-identical on every backend: f32
    division on the GPU is not correctly rounded (a random sample: 28%
    of quotients differ from the IEEE result by an ulp; none on the
    CPU), and a one-ulp difference in a sample flips exact-compare
    decisions."""
    return (np.arange(n) / max(n - 1, 1)).astype(np.float32)


def recip(c):
    """1 / c as an f32 constant (see :func:`unit_grid`)."""
    return np.float32(1.0 / c)


def lex_argmin(constr, cost):
    """Lexicographic (constr, cost) argmin along the last axis, the
    first minimum winning (the reference's sequential two-key scan).
    Returns (index, min constraint, constr, cost).

    Both operands pass an optimization barrier first, and the returned
    ``constr``/``cost`` are the barriered buffers for the caller's
    lookups: otherwise XLA may compute them once inside the min
    reduction and again inside the compare, rounded differently, and
    then no action compares equal to the minimum."""
    constr, cost = jax.lax.optimization_barrier((constr, cost))
    cmin = jnp.min(constr, axis=-1, keepdims=True)
    idx = jnp.argmin(jnp.where(constr == cmin, cost, jnp.inf), axis=-1)
    return idx, cmin[..., 0], constr, cost
