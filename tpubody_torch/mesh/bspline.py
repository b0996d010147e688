"""B-spline interpolation and evaluation on the host in numpy (replaces
geomdl; the port of the numpy path of ``tpubody.mesh.bspline``).

Capability parity with the reference's geomdl wrappers
(utils/B_Spline.py:10-141: interpolate_curve, CurveContainer batch,
interpolate_surface, construct_surface loft):

  * global curve interpolation = chord-length parameterization + averaged
    knots + one dense collocation solve (systems are tiny: n <= a few
    hundred),
  * evaluation = Cox-de Boor basis *matrix* (m, n) times control points,
  * batched curves as one vectorized solve over a leading batch axis (the
    reference loops geomdl objects in python),
  * tensor-product surfaces: interpolate rows then columns; evaluation is
    two products B_u @ C @ B_v^T.

``tpubody`` also has a jit+vmap route for traced inputs
(``tpubody/mesh/bspline.py:240-256``).  No caller there traces these
functions: the stitch band and the hand graft pass concrete arrays
(``stitch.py:116``, ``hands.py:67`` and ``:241``), so that route is not
ported and every function here is the numpy path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Curve(NamedTuple):
    control: np.ndarray   # (n, dim)
    knots: np.ndarray     # (n + degree + 1,)
    degree: int


class Surface(NamedTuple):
    control: np.ndarray   # (nu, nv, dim)
    knots_u: np.ndarray
    knots_v: np.ndarray
    degree_u: int
    degree_v: int


def chord_length_params(points: np.ndarray) -> np.ndarray:
    """Normalized chord-length parameters t_0=0 .. t_{n-1}=1.

    Coincident points would repeat parameters, making the collocation
    matrix singular (NaN fits — seen on pinched stitch rings where the
    inner and outer boundary coincide); a tiny uniform blend keeps the
    parameters strictly increasing.  Interpolation stays exact at the
    data points regardless of parameterization; only the inter-point
    shape shifts, by O(1e-4)."""
    points = np.asarray(points)
    d = np.linalg.norm(np.diff(points, axis=0), axis=-1)
    total = np.sum(d)
    d = d + (total + 1e-9) * (1e-4 / max(d.shape[0], 1))
    t = np.concatenate([np.zeros(1, points.dtype), np.cumsum(d)])
    return t / t[-1]


def averaged_knots(params: np.ndarray, degree: int, n: int) -> np.ndarray:
    """Knot vector by parameter averaging (de Boor / NURBS-book 9.8)."""
    params = np.asarray(params)
    p = degree
    # interior knots: u_{j+p} = mean(params[j .. j+p-1]), j = 1..n-p-1
    if n - p - 1 > 0:
        windows = np.stack(
            [params[j:j + p] for j in range(1, n - p)], axis=0)  # (n-p-1, p)
        interior = np.mean(windows, axis=1)
    else:
        interior = np.zeros((0,), params.dtype)
    return np.concatenate([
        np.zeros(p + 1, params.dtype),
        interior,
        np.ones(p + 1, params.dtype),
    ])


def basis_matrix(u: np.ndarray, knots: np.ndarray, degree: int,
                 n: int) -> np.ndarray:
    """Cox-de Boor basis functions N_{i,p}(u) for all i, vectorized.

    Args:
      u: (m,) parameters in [0, 1].
      knots: (n + degree + 1,).
      n: number of basis functions / control points.

    Returns:
      (m, n) matrix; rows sum to 1.
    """
    u, knots = np.asarray(u), np.asarray(knots)
    p = degree
    u = np.clip(u, 0.0, 1.0)
    nk = n + p  # number of degree-0 spans

    # Degree 0: indicator of the half-open span, with the final span closed.
    lo = knots[:nk]
    hi = knots[1:nk + 1]
    N = ((u[:, None] >= lo[None, :]) & (u[:, None] < hi[None, :])).astype(
        u.dtype)
    # u == 1 belongs to the last nonempty span.
    last = (hi >= 1.0) & (lo < 1.0)
    N = np.where((u[:, None] >= 1.0) & last[None, :], 1.0, N)

    for d in range(1, p + 1):
        cnt = nk - d
        left_den = knots[d:d + cnt] - knots[:cnt]
        right_den = knots[d + 1:d + 1 + cnt] - knots[1:1 + cnt]
        left = np.where(
            left_den > 1e-12,
            (u[:, None] - knots[None, :cnt]) / np.where(
                left_den > 1e-12, left_den, 1.0)[None, :] * N[:, :cnt],
            0.0)
        right = np.where(
            right_den > 1e-12,
            (knots[None, d + 1:d + 1 + cnt] - u[:, None]) / np.where(
                right_den > 1e-12, right_den, 1.0)[None, :] * N[:, 1:1 + cnt],
            0.0)
        N = left + right
    return N[:, :n]


def interpolate_curve(points: np.ndarray, degree: int = 3) -> Curve:
    """Global interpolation: the curve passes through all points
    (geomdl fitting.interpolate_curve parity)."""
    points = np.asarray(points)
    n = points.shape[0]
    degree = min(degree, n - 1)
    t = chord_length_params(points)
    knots = averaged_knots(t, degree, n)
    A = basis_matrix(t, knots, degree, n)
    control = np.linalg.solve(A, points)
    return Curve(control=control, knots=knots, degree=degree)


def eval_curve(curve: Curve, num: int) -> np.ndarray:
    """Evaluate at ``num`` evenly spaced parameters (delta = 1/(num-1))."""
    u = np.linspace(0.0, 1.0, num).astype(np.asarray(curve.knots).dtype)
    B = basis_matrix(u, curve.knots, curve.degree, curve.control.shape[0])
    return B @ np.asarray(curve.control)


def fit_curve_points(points: np.ndarray, degree: int, num: int
                     ) -> np.ndarray:
    """One-shot: interpolate then resample to ``num`` points."""
    return eval_curve(interpolate_curve(points, degree), num)


def _basis_matrix_batched_np(u: np.ndarray, knots: np.ndarray, p: int,
                             n: int) -> np.ndarray:
    """Cox-de Boor with a leading batch axis: u (B, m), knots (B, n+p+1)
    -> (B, m, n).  Same recursion as :func:`basis_matrix`."""
    u = np.clip(u, 0.0, 1.0)
    nk = n + p
    lo = knots[:, None, :nk]
    hi = knots[:, None, 1:nk + 1]
    uu = u[:, :, None]
    N = ((uu >= lo) & (uu < hi)).astype(np.float64)
    last = (hi >= 1.0) & (lo < 1.0)
    N = np.where((uu >= 1.0) & last, 1.0, N)
    for d in range(1, p + 1):
        cnt = nk - d
        left_den = knots[:, None, d:d + cnt] - knots[:, None, :cnt]
        right_den = (knots[:, None, d + 1:d + 1 + cnt]
                     - knots[:, None, 1:1 + cnt])
        left = np.where(
            left_den > 1e-12,
            (uu - knots[:, None, :cnt])
            / np.where(left_den > 1e-12, left_den, 1.0) * N[..., :cnt], 0.0)
        right = np.where(
            right_den > 1e-12,
            (knots[:, None, d + 1:d + 1 + cnt] - uu)
            / np.where(right_den > 1e-12, right_den, 1.0)
            * N[..., 1:1 + cnt], 0.0)
        N = left + right
    return N[..., :n]


def _fit_curves_batch_np(points: np.ndarray, degree: int,
                         num: int) -> np.ndarray:
    """Vectorized batch fit+resample in float64, cast back to the input's
    dtype.  The batch size B is a per-image ring length in the stitch
    stage; tiny (n x n) collocation systems solve in microseconds here."""
    pts_in = np.asarray(points)
    pts = pts_in.astype(np.float64)
    B, n, _ = pts.shape
    p = min(degree, n - 1)
    # batched chord_length_params
    d = np.linalg.norm(np.diff(pts, axis=1), axis=-1)          # (B, n-1)
    total = d.sum(axis=1, keepdims=True)
    d = d + (total + 1e-9) * (1e-4 / max(n - 1, 1))
    t = np.concatenate([np.zeros((B, 1)), np.cumsum(d, axis=1)], axis=1)
    t = t / t[:, -1:]
    # batched averaged_knots
    if n - p - 1 > 0:
        windows = np.stack([t[:, j:j + p] for j in range(1, n - p)], axis=1)
        interior = windows.mean(axis=2)                        # (B, n-p-1)
    else:
        interior = np.zeros((B, 0))
    knots = np.concatenate(
        [np.zeros((B, p + 1)), interior, np.ones((B, p + 1))], axis=1)
    A = _basis_matrix_batched_np(t, knots, p, n)               # (B, n, n)
    control = np.linalg.solve(A, pts)
    u = np.broadcast_to(np.linspace(0.0, 1.0, num), (B, num))
    Bm = _basis_matrix_batched_np(u, knots, p, n)              # (B, num, n)
    return (Bm @ control).astype(pts_in.dtype, copy=False)


def fit_curves_batch(points: np.ndarray, degree: int, num: int
                     ) -> np.ndarray:
    """Batched curve fit+resample: (B, n, dim) -> (B, num, dim), one
    vectorized solve for all curves (the reference loops geomdl objects
    per curve, utils/B_Spline.py:46)."""
    return _fit_curves_batch_np(points, degree, num)


def interpolate_surface(grid: np.ndarray, degree_u: int = 3,
                        degree_v: int = 3) -> Surface:
    """Tensor-product surface through a (nu, nv, dim) grid of points
    (geomdl fitting.interpolate_surface parity)."""
    grid = np.asarray(grid)
    nu, nv = grid.shape[0], grid.shape[1]
    degree_u = min(degree_u, nu - 1)
    degree_v = min(degree_v, nv - 1)

    # Average chord-length parameters across rows/cols (NURBS-book 9.9).
    tu = np.mean([chord_length_params(grid[:, j]) for j in range(nv)],
                 axis=0)
    tv = np.mean([chord_length_params(grid[i]) for i in range(nu)], axis=0)
    ku = averaged_knots(tu, degree_u, nu)
    kv = averaged_knots(tv, degree_v, nv)

    Au = basis_matrix(tu, ku, degree_u, nu)          # (nu, nu)
    Av = basis_matrix(tv, kv, degree_v, nv)          # (nv, nv)

    # Solve along v for each u-row, then along u.
    # R[i] = Av^{-1} grid[i]  ->  control = Au^{-1} R
    R = np.linalg.solve(Av, grid)                    # batched over nu rows
    control = np.linalg.solve(Au, R.reshape(nu, -1)).reshape(nu, nv, -1)
    return Surface(control=control, knots_u=ku, knots_v=kv,
                   degree_u=degree_u, degree_v=degree_v)


def eval_surface(surface: Surface, num_u: int, num_v: int) -> np.ndarray:
    """(num_u, num_v, dim) sample grid — two products."""
    nu, nv = surface.control.shape[0], surface.control.shape[1]
    dt = np.asarray(surface.knots_u).dtype
    u = np.linspace(0.0, 1.0, num_u).astype(dt)
    v = np.linspace(0.0, 1.0, num_v).astype(dt)
    Bu = basis_matrix(u, surface.knots_u, surface.degree_u, nu)  # (mu, nu)
    Bv = basis_matrix(v, surface.knots_v, surface.degree_v, nv)  # (mv, nv)
    tmp = np.einsum("ui,ivd->uvd", Bu, np.asarray(surface.control))
    return np.einsum("vj,ujd->uvd", Bv, tmp)


def grid_faces(num_u: int, num_v: int) -> np.ndarray:
    """Triangulation of a (num_u, num_v) sample grid -> (F, 3) indices into
    the row-major flattened grid (replaces geomdl surface.faces)."""
    iu, iv = np.meshgrid(np.arange(num_u - 1), np.arange(num_v - 1),
                         indexing="ij")
    v00 = (iu * num_v + iv).ravel()
    v01 = v00 + 1
    v10 = v00 + num_v
    v11 = v10 + 1
    tris = np.concatenate([
        np.stack([v00, v10, v11], axis=1),
        np.stack([v00, v11, v01], axis=1),
    ], axis=0)
    return tris.astype(np.int32)


def loft_surface(curves_points: np.ndarray, degree_u: int = 2,
                 degree_v: int = 3) -> Surface:
    """Loft a surface through K sampled curves (rows of the grid)
    (geomdl construct_surface parity, utils/B_Spline.py:107-141: the stitch
    band lofts 4 boundary rings, lib/Depth2Mesh_Bspline.py:417-445)."""
    return interpolate_surface(curves_points, degree_u=degree_u,
                               degree_v=degree_v)
