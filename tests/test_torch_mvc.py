"""tpubody_torch.image.mvc against tpubody.image.mvc on the CPU.

Tolerances: the weights are quotients of float32 sums over the polygon
taken in another order than XLA takes them: 1e-5 on weights that sum to 1
(the on-vertex and on-edge cases are selected by the same float32
comparisons and are exact deltas / two-point interpolations; they are
tested on integer pixels and polygons, the stage's real input, where the
cross product of a point on an edge is an exact zero.  A float point
NEAR an oblique edge divides two rounding residues and is not
comparable between two compilers).  Transported
points are weighted sums of coordinates up to 128: 1e-4 pixels."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.image import mvc as JM
from tpubody_torch.image import mvc as TM

torch.set_num_threads(1)
W_ATOL = 1e-5
PT_ATOL = 1e-4


def star(n=40, seed=0):
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(20, 50, n)
    return np.stack([64 + r * np.cos(ang), 64 + r * np.sin(ang)], 1
                    ).astype(np.float32)


def queries(poly, seed=1, m=300):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(50, 78, size=(m, 2)).astype(np.float32)  # interior
    pts[:5] = poly[[0, 3, 7, 11, 39]]                          # on vertices
    return pts


def pixel_case():
    """The stage's real input: an integer contour polygon (simplified, so
    it has long axis-aligned and diagonal edges) and every pixel of its
    mask, the contour pixels included: those lie on vertices or exactly on
    edges (integer cross products are exact zeros)."""
    from tpubody_torch.image import contours

    yy, xx = np.mgrid[0:64, 0:64]
    mask = ((xx - 32) / 24.0) ** 2 + ((yy - 32) / 14.0) ** 2 < 1
    poly = contours.simplify(contours.trace_boundary(mask))
    return contours.inner_points(mask), poly


def test_weights():
    square = np.array([[0, 0], [64, 0], [64, 64], [0, 64]], np.float32)
    sq_pts = np.array([[32, 32], [0, 0], [64, 64], [32, 0], [64, 16],
                       [10, 50]], np.float32)
    for pts, poly in ((queries(star()), star()), pixel_case(),
                      (sq_pts, square)):
        want = np.asarray(JM.mean_value_coordinates(jnp.asarray(pts),
                                                    jnp.asarray(poly)))
        got = TM.mean_value_coordinates(torch.as_tensor(pts),
                                        torch.as_tensor(poly)).numpy()
        np.testing.assert_allclose(got, want, atol=W_ATOL)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    # on a vertex: a delta; on an axis-aligned edge: its two endpoints
    np.testing.assert_array_equal(got[1], [1, 0, 0, 0])
    np.testing.assert_allclose(got[3], [0.5, 0.5, 0, 0], atol=1e-7)
    np.testing.assert_allclose(got[4], [0, 0.75, 0.25, 0], atol=1e-7)


def test_integer_inputs_are_cast():
    poly = star().astype(np.int64)
    pts = queries(star()).astype(np.int64)
    want = np.asarray(JM.mean_value_coordinates(jnp.asarray(pts),
                                                jnp.asarray(poly)))
    got = TM.mean_value_coordinates(torch.as_tensor(pts),
                                    torch.as_tensor(poly))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=W_ATOL)


@pytest.mark.parametrize("chunk", [None, 128, 1000])
def test_warp_points(chunk):
    src = star()
    dst = (src * 1.2 + np.float32([3.0, -4.0])).astype(np.float32)
    pts = queries(src, m=1000)
    want = np.asarray(JM.warp_points(jnp.asarray(pts), jnp.asarray(src),
                                     jnp.asarray(dst)))
    args = [torch.as_tensor(x) for x in (pts, src, dst)]
    got = (TM.warp_points(*args) if chunk is None
           else TM.warp_points_chunked(*args, chunk=chunk))
    assert tuple(got.shape) == (1000, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=PT_ATOL)
    # an affine map of the polygon moves interior points by the same map
    np.testing.assert_allclose(got.numpy()[10:], pts[10:] * 1.2 + [3.0, -4.0],
                               atol=1e-3)


def test_warp_points_chunked_empty():
    out = TM.warp_points_chunked(torch.zeros(0, 2), torch.as_tensor(star()),
                                 torch.as_tensor(star()))
    assert tuple(out.shape) == (0, 2)
