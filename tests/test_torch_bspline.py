"""tpubody_torch.mesh.bspline: tests/test_bspline.py's cases on the port
(the interpolation property, end points, linear precision, partition of
unity, degree clamping, batch against single, surfaces, lofts, and the
scipy design-matrix and evaluation oracles, with that file's tolerances),
and every function against tpubody's numpy path on the same seeded numpy
inputs.  Both run the same numpy arithmetic, so those are held equal bit
for bit (tolerance 0), in float32 (the stitch band and the hand graft
call with float32) and float64."""
import numpy as np
import pytest

from tpubody.mesh import bspline as JB
from tpubody_torch.mesh import bspline as TB


class TestCurve:
    def test_interpolation_property(self):
        rng = np.random.default_rng(0)
        pts = np.cumsum(rng.normal(size=(9, 3)), axis=0).astype(np.float32)
        curve = TB.interpolate_curve(pts, degree=3)
        t = TB.chord_length_params(pts)
        B = TB.basis_matrix(t, curve.knots, curve.degree,
                            curve.control.shape[0])
        np.testing.assert_allclose(B @ curve.control, pts, atol=2e-4)

    def test_endpoints_exact(self):
        pts = np.asarray([[0, 0, 0], [1, 2, 0], [3, 1, 0], [4, 4, 0]],
                         np.float32)
        out = TB.fit_curve_points(pts, 3, 20)
        np.testing.assert_allclose(out[0], [0, 0, 0], atol=1e-5)
        np.testing.assert_allclose(out[-1], [4, 4, 0], atol=1e-5)

    def test_linear_precision(self):
        t = np.linspace(0, 1, 7)[:, None]
        pts = (t * np.array([[2.0, -1.0, 3.0]])).astype(np.float32)
        out = TB.fit_curve_points(pts, 3, 33)
        d = np.array([2.0, -1.0, 3.0])
        d /= np.linalg.norm(d)
        assert np.abs(out - np.outer(out @ d, d)).max() < 1e-4

    def test_partition_of_unity(self):
        pts = np.random.default_rng(1).normal(size=(8, 2)).astype(np.float32)
        curve = TB.interpolate_curve(pts, 3)
        B = TB.basis_matrix(np.linspace(0, 1, 50).astype(np.float32),
                            curve.knots, 3, 8)
        np.testing.assert_allclose(B.sum(1), 1.0, atol=1e-5)
        assert (B >= -1e-6).all()

    def test_degree_clamped_for_few_points(self):
        pts = np.asarray([[0, 0], [1, 1], [2, 0]], np.float32)
        out = TB.fit_curve_points(pts, 3, 10)       # degree -> 2
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out[0], [0, 0], atol=1e-5)

    def test_batched_matches_single(self):
        rng = np.random.default_rng(2)
        pts = rng.normal(size=(5, 7, 3)).cumsum(axis=1).astype(np.float32)
        batch = TB.fit_curves_batch(pts, 2, 15)
        for i in range(5):
            np.testing.assert_allclose(
                batch[i], TB.fit_curve_points(pts[i], 2, 15), atol=1e-5)


def saddle_grid(nu=5, nv=6):
    u, v = np.linspace(-1, 1, nu), np.linspace(-1, 1, nv)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    return np.stack([uu, vv, uu * vv], axis=-1).astype(np.float32)


def rings(n=24):
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([np.stack([np.cos(theta), np.sin(theta),
                               np.full_like(theta, z)], axis=-1)
                     for z in (0.0, 1.0, 2.0, 3.0)]).astype(np.float32)


class TestSurface:
    def test_surface_interpolates_grid(self):
        grid = saddle_grid()
        out = TB.eval_surface(TB.interpolate_surface(grid, 3, 3), 5, 6)
        np.testing.assert_allclose(out, grid, atol=1e-4)

    def test_surface_corners(self):
        grid = saddle_grid(4, 4)
        out = TB.eval_surface(TB.interpolate_surface(grid, 2, 2), 11, 13)
        np.testing.assert_allclose(out[0, 0], grid[0, 0], atol=1e-4)
        np.testing.assert_allclose(out[-1, -1], grid[-1, -1], atol=1e-4)

    def test_dense_sampling_smooth(self):
        out = TB.eval_surface(TB.interpolate_surface(saddle_grid(), 3, 3),
                              30, 30)
        assert np.abs(out[..., 2] - out[..., 0] * out[..., 1]).max() < 0.05

    def test_grid_faces(self):
        f = TB.grid_faces(3, 4)
        assert f.shape == (2 * 2 * 3, 3)
        assert f.max() == 11 and f.min() == 0
        np.testing.assert_array_equal(f, JB.grid_faces(3, 4))

    def test_loft_through_curves(self):
        surf = TB.loft_surface(rings(), degree_u=2, degree_v=3)
        out = TB.eval_surface(surf, 10, 48)
        r = np.linalg.norm(out[..., :2], axis=-1)
        assert abs(r.mean() - 1.0) < 0.05
        assert out[..., 2].min() > -0.01 and out[..., 2].max() < 3.01


class TestScipyOracle:
    def test_basis_matrix_matches_scipy_design_matrix(self):
        from scipy.interpolate import BSpline
        pts = np.random.default_rng(0).normal(size=(9, 3))
        t = TB.chord_length_params(pts)
        knots = TB.averaged_knots(t, 3, 9)
        u = np.linspace(0.0, 0.999999, 40)  # scipy's basis is right-open
        theirs = BSpline.design_matrix(u, knots, 3).toarray()
        np.testing.assert_allclose(TB.basis_matrix(u, knots, 3, 9), theirs,
                                   atol=1e-9)

    def test_curve_evaluation_matches_scipy_bspline(self):
        from scipy.interpolate import BSpline
        pts = np.random.default_rng(1).normal(size=(7, 2))
        curve = TB.interpolate_curve(pts, degree=3)
        spl = BSpline(curve.knots, curve.control, curve.degree)
        u = np.linspace(0.0, 1.0, 25)
        np.testing.assert_allclose(TB.eval_curve(curve, 25),
                                   spl(np.clip(u, 0.0, 1.0 - 1e-12)),
                                   atol=1e-6)
        t = TB.chord_length_params(pts)
        np.testing.assert_allclose(spl(np.clip(t, 0.0, 1.0 - 1e-12)), pts,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_curves_equal_tpubodys(dtype):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(11, 3)).cumsum(axis=0).astype(dtype)
    for a, b in zip(TB.interpolate_curve(pts, 3),
                    JB.interpolate_curve(pts, 3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TB.fit_curve_points(pts, 2, 21),
                                  JB.fit_curve_points(pts, 2, 21))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [4, 9])
def test_fit_curves_batch_equals_tpubodys(dtype, n):
    """The stitch band's call: every second cross-curve of 4 rings."""
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(37, 4 if n == 4 else n, 3)).cumsum(
        axis=1).astype(dtype)
    got = TB.fit_curves_batch(pts, 2, 11)
    assert got.dtype == dtype and got.shape == (37, 11, 3)
    np.testing.assert_array_equal(got, JB.fit_curves_batch(pts, 2, 11))
    np.testing.assert_array_equal(
        TB._basis_matrix_batched_np(np.tile(np.linspace(0, 1, 5), (2, 1)),
                                    np.tile(JB.averaged_knots(
                                        np.linspace(0, 1, 6), 2, 6), (2, 1)),
                                    2, 6),
        JB._basis_matrix_batched_np(np.tile(np.linspace(0, 1, 5), (2, 1)),
                                    np.tile(JB.averaged_knots(
                                        np.linspace(0, 1, 6), 2, 6), (2, 1)),
                                    2, 6))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_loft_and_surface_equal_tpubodys(dtype):
    """The hand graft's call: a (4, n, 3) loft, degree 3 x 2, sampled at
    21 rows."""
    r = rings(16).astype(dtype)
    r[1:3, :, :2] *= 0.8
    got = TB.loft_surface(r, degree_u=3, degree_v=2)
    want = JB.loft_surface(r, degree_u=3, degree_v=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TB.eval_surface(got, 21, 16),
                                  JB.eval_surface(want, 21, 16))
    grid = saddle_grid().astype(dtype)
    np.testing.assert_array_equal(
        TB.eval_surface(TB.interpolate_surface(grid, 3, 3), 9, 7),
        JB.eval_surface(JB.interpolate_surface(grid, 3, 3), 9, 7))
