"""
Interpolation primitives shared between host (numpy) and device (jax) code.

These reproduce the interpolation semantics of the reference's generated
solver runtime (reference: library/tpl/optim/templates/optim.c:332-480,
``lerp``/``lerp_angle``/``box_interp``/``blerp`` with clamped equally-spaced
indices) and the python helpers (library/tpl/util.py:70-108).

All functions are written against the array-namespace, so they work for both
``numpy`` arrays (host orchestration) and ``jax.numpy`` arrays (inside jit).
"""

import numpy as np
import jax
import jax.numpy as jnp


def _xp(*arrays):
    """Pick jnp if any argument is a jax array, else numpy."""
    for a in arrays:
        if isinstance(a, jnp.ndarray) and not isinstance(a, np.ndarray):
            return jnp
    return np


def normalize_angle(a):
    """Normalize angle(s) to (-pi, pi]. (reference: library/tpl/util.py:92-100)"""
    xp = _xp(a)
    a = xp.mod(xp.mod(a, 2 * np.pi) + 2 * np.pi, 2 * np.pi)
    return xp.where(a > np.pi, a - 2 * np.pi, a)


def short_angle_dist(a0, a1):
    """Shortest signed angular distance from a0 to a1, in [-pi, pi).

    (reference: library/tpl/optim/templates/optim.c:332-338 shortAngleDist)
    Implemented as the single-mod form ``mod(da + pi, 2pi) - pi``, which
    is the identical function to the reference's double-mod form in
    exact arithmetic but has no float32 cancellation catastrophe: the
    double-mod rounds ``mod(-1e-9, 2pi)`` to exactly 2pi in f32, making
    the result -2pi instead of ~0 — measured as spurious +-2pi
    curvature spikes in the fused lateral-path splice."""
    xp = _xp(a0, a1)
    return xp.mod((a1 - a0) + np.pi, 2 * np.pi) - np.pi


def _interp_indices(x0, dx, x, size, xp):
    """Clamped equally-spaced interpolation indices.

    (reference: optim.c:346-355 initInterp: floor/ceil indices clamped to
    [0, size-1], alpha = clip(q - start, 0, 1))
    """
    q = (x - x0) / dx
    start = xp.clip(xp.floor(q), 0, size - 1).astype(int)
    end = xp.clip(xp.ceil(q), 0, size - 1).astype(int)
    a = xp.clip(q - start, 0.0, 1.0)
    return start, end, a


# For tables up to _ONEHOT_MAX entries the lookups are an explicit
# hat-function / one-hot contraction, which fuses into the surrounding
# elementwise ops instead of issuing a gather inside every scan step.
# Semantics are identical to the clamped-index lookups used above it.
_ONEHOT_MAX = 1024


def _onehot_take(arr, idx):
    """arr[idx] via one-hot contraction (jnp path)."""
    c = arr.shape[0]
    iota = jnp.arange(c)
    onehot = (idx[..., None] == iota).astype(arr.dtype)
    return jnp.sum(onehot * arr, axis=-1)


# The one-hot lookups carry custom analytic derivatives: autodiff through
# the hat-weight construction materializes (batch, n)-wide tangent
# intermediates per lookup and dominated the batched-solver profile
# (multiply_reduce fusions).  The analytic piecewise-linear tangents are
# exactly what the reference's symbolic codegen produces for lerp /
# lerp_angle / boxInterp (optim.c:332-480): slope (v1 - v0) inside the
# table, zero in the clamped regions, zero second derivative.


def _is_zero(t):
    return isinstance(t, jax.custom_derivatives.SymbolicZero)


@jax.custom_jvp
def _hat_lerp(q, arr):
    """Clamped linear interpolation of `arr` at fractional index `q`."""
    n = arr.shape[0]
    qc = jnp.clip(q, 0.0, n - 1.0)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(qc[..., None] - jnp.arange(n)))
    return jnp.sum(w * arr, axis=-1)


def _hat_lerp_jvp(primals, tangents):
    # genopt-parity slope: start=floor, end=ceil, both clamped
    # (optim.c:346-355) — at exactly-on-grid queries start == end, so the
    # lookup contributes ZERO derivative, exactly like the generated C.
    q, arr = primals
    dq, darr = tangents
    n = arr.shape[0]
    i0 = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
    a = jnp.clip(q - i0, 0.0, 1.0)
    v0 = _onehot_take(arr, i0)
    v1 = _onehot_take(arr, i1)
    val = v0 + a * (v1 - v0)
    dval = jnp.zeros_like(val)
    if not _is_zero(dq):
        dval = dval + (v1 - v0) * dq
    if not _is_zero(darr):
        dv0 = _onehot_take(darr, i0)
        dv1 = _onehot_take(darr, i1)
        dval = dval + dv0 + a * (dv1 - dv0)
    return val, dval


_hat_lerp.defjvp(_hat_lerp_jvp, symbolic_zeros=True)


@jax.custom_jvp
def _hat_lerp_angle(q, arr):
    """Clamped short-angle interpolation at fractional index `q`."""
    n = arr.shape[0]
    qc = jnp.clip(q, 0.0, n - 1.0)
    i0 = jnp.clip(jnp.floor(qc), 0, n - 1).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(qc), 0, n - 1).astype(jnp.int32)
    a = jnp.clip(qc - i0, 0.0, 1.0)
    v0 = _onehot_take(arr, i0)
    v1 = _onehot_take(arr, i1)
    return v0 + short_angle_dist(v0, v1) * a


def _hat_lerp_angle_jvp(primals, tangents):
    q, arr = primals
    dq, darr = tangents
    n = arr.shape[0]
    qc = jnp.clip(q, 0.0, n - 1.0)
    i0 = jnp.clip(jnp.floor(qc), 0, n - 1).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(qc), 0, n - 1).astype(jnp.int32)
    a = jnp.clip(qc - i0, 0.0, 1.0)
    v0 = _onehot_take(arr, i0)
    v1 = _onehot_take(arr, i1)
    sad = short_angle_dist(v0, v1)
    val = v0 + sad * a
    dval = jnp.zeros_like(val)
    if not _is_zero(dq):
        # genopt-parity: slope sad(v0, v1); zero on-grid since v0 == v1
        dval = dval + sad * dq
    if not _is_zero(darr):
        dv0 = _onehot_take(darr, i0)
        dv1 = _onehot_take(darr, i1)
        dval = dval + dv0 + a * (dv1 - dv0)
    return val, dval


_hat_lerp_angle.defjvp(_hat_lerp_angle_jvp, symbolic_zeros=True)


@jax.custom_jvp
def _hat_box(q, arr):
    """Clamped nearest-below lookup at fractional index `q`."""
    n = arr.shape[0]
    i = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
    return _onehot_take(arr, i)


def _hat_box_jvp(primals, tangents):
    q, arr = primals
    dq, darr = tangents
    n = arr.shape[0]
    i = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
    val = _onehot_take(arr, i)
    dval = jnp.zeros_like(val)
    if not _is_zero(darr):
        dval = _onehot_take(darr, i)
    return val, dval


_hat_box.defjvp(_hat_box_jvp, symbolic_zeros=True)


def _onehot_rows(mat, idx):
    """mat[idx, :] via one-hot contraction; mat (n, C), idx (...,)."""
    n = mat.shape[0]
    onehot = (idx[..., None] == jnp.arange(n)).astype(mat.dtype)
    return jnp.tensordot(onehot, mat, axes=([-1], [0]))


@jax.custom_jvp
def _hat_lerp_multi(q, mat):
    """Clamped linear interpolation of each column of `mat` at index `q`.

    One hat-weight construction amortized over all C tables — the weight
    build dominates when several lookups share the query (profiled on the
    batched MPC), and the contraction is one matrix product.
    """
    n = mat.shape[0]
    qc = jnp.clip(q, 0.0, n - 1.0)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(qc[..., None] - jnp.arange(n)))
    return jnp.tensordot(w.astype(mat.dtype), mat, axes=([-1], [0]))


def _hat_lerp_multi_jvp(primals, tangents):
    # genopt-parity floor/ceil slope, see _hat_lerp_jvp
    q, mat = primals
    dq, dmat = tangents
    n = mat.shape[0]
    i0 = jnp.clip(jnp.floor(q), 0, n - 1).astype(jnp.int32)
    i1 = jnp.clip(jnp.ceil(q), 0, n - 1).astype(jnp.int32)
    a = jnp.clip(q - i0, 0.0, 1.0)[..., None]
    v0 = _onehot_rows(mat, i0)
    v1 = _onehot_rows(mat, i1)
    val = v0 + a * (v1 - v0)
    dval = jnp.zeros_like(val)
    if not _is_zero(dq):
        dval = dval + (v1 - v0) * dq[..., None]
    if not _is_zero(dmat):
        dv0 = _onehot_rows(dmat, i0)
        dv1 = _onehot_rows(dmat, i1)
        dval = dval + dv0 + a * (dv1 - dv0)
    return val, dval


_hat_lerp_multi.defjvp(_hat_lerp_multi_jvp, symbolic_zeros=True)


def lerp_multi(x0, dx, x, mat):
    """Linear interpolation into several tables sharing one query.

    ``mat`` is (n, C) — C equally spaced tables stacked column-wise.
    Returns shape (..., C).  Semantics per column identical to
    :func:`lerp`.
    """
    xp = _xp(x, mat)
    mat = xp.asarray(mat)
    n = mat.shape[0]
    if xp is jnp and n <= _ONEHOT_MAX:
        return _hat_lerp_multi((jnp.asarray(x) - x0) / dx, mat)
    start, end, a = _interp_indices(x0, dx, x, n, xp)
    a = a[..., None] if xp.ndim(a) else a
    return (1.0 - a) * mat[start] + a * mat[end]


def lerp(x0, dx, x, arr):
    """Linear interpolation into equally spaced 1-D array `arr`.

    Matches optim.c ``lerp`` semantics: indices clamped at the boundaries,
    alpha clamped to [0, 1] (constant extrapolation).
    """
    xp = _xp(x, arr)
    arr = xp.asarray(arr)
    n = arr.shape[0]
    if xp is jnp and n <= _ONEHOT_MAX:
        return _hat_lerp((jnp.asarray(x) - x0) / dx, arr)
    start, end, a = _interp_indices(x0, dx, x, n, xp)
    return (1.0 - a) * arr[start] + a * arr[end]


def lerp_angle(x0, dx, x, arr):
    """Like :func:`lerp` but interpolates along the short angular distance."""
    xp = _xp(x, arr)
    arr = xp.asarray(arr)
    n = arr.shape[0]
    if xp is jnp and n <= _ONEHOT_MAX:
        return _hat_lerp_angle((jnp.asarray(x) - x0) / dx, arr)
    start, end, a = _interp_indices(x0, dx, x, n, xp)
    return arr[start] + short_angle_dist(arr[start], arr[end]) * a


def box_interp(dx, x, arr):
    """Nearest-below (piecewise constant) lookup. (optim.c:357-369)"""
    xp = _xp(x, arr)
    arr = xp.asarray(arr)
    if xp is jnp and arr.shape[0] <= _ONEHOT_MAX:
        return _hat_box(jnp.asarray(x) / dx, arr)
    i = xp.clip(xp.floor(x / dx), 0, arr.shape[0] - 1).astype(int)
    return arr[i]


def blerp(x0, y0, dx, dy, x, y, arr):
    """Bilinear interpolation into equally spaced 2-D array. (optim.c:452-480)"""
    xp = _xp(x, y, arr)
    arr = xp.asarray(arr)
    rows, cols = arr.shape
    xs, xe, xa = _interp_indices(x0, dx, x, cols, xp)
    ys, ye, ya = _interp_indices(y0, dy, y, rows, xp)
    p0 = (1.0 - ya) * arr[ys, xs] + ya * arr[ye, xs]
    p1 = (1.0 - ya) * arr[ys, xe] + ya * arr[ye, xe]
    return (1.0 - xa) * p0 + xa * p1


def lerp_xs(x, xs, ys, angle=False, clip_alpha=False):
    """Interpolation assuming equally spaced `xs`, vector-valued `ys`.

    (reference: library/tpl/environment/prediction_module.py:10-38)
    """
    xp = _xp(x, xs, ys)
    ys = xp.asarray(ys)
    l = ys.shape[0]
    if l == 1:
        return ys[0]
    dx = xs[1] - xs[0]
    q = (x - xs[0]) / dx
    start = xp.clip(xp.floor(q), 0, l - 2).astype(int)
    end = xp.clip(xp.ceil(q), 0, l - 1).astype(int)
    a = q - start
    if clip_alpha:
        a = xp.clip(a, 0.0, 1.0)
    if angle:
        return ys[start] + short_angle_dist(ys[start], ys[end]) * a
    if ys.ndim > 1:
        a = xp.expand_dims(a, -1) if xp.ndim(a) else a
    return ys[start] * (1.0 - a) + ys[end] * a
