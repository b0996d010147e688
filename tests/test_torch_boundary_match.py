"""tpubody_torch.image.boundary_match against tpubody.image.boundary_match
on the CPU.

Contours are integer pixel coordinates below 2^12, so squared distances
are exact in float32 on both sides and the square roots are correctly
rounded: cost rows are equal, and so are the matched indices.  Ties are
frequent on integer contours; both sides keep the nearest column (the
smallest shift), which the windowed-minimum test pins directly."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.image import boundary_match as JB
from tpubody.image import contours as JC
from tpubody_torch.image import boundary_match as TB

from tests.test_torch_contours import disk

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_windowed_min_equal_with_ties(k):
    rng = np.random.default_rng(k)
    row = rng.integers(0, 4, size=100).astype(np.float32)  # many ties
    row[7] = 1e12
    jbest, jidx = JB._windowed_min(jnp.asarray(row), k)
    best, idx = TB._windowed_min(torch.as_tensor(row), k)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_dp_tables_equal():
    rng = np.random.default_rng(1)
    dist = rng.integers(0, 30, size=(40, 60)).astype(np.float32)
    jrow, jargs = JB._dp_tables(jnp.asarray(dist), 8)
    row, args = TB._dp_tables(torch.as_tensor(dist), 8)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(args.numpy(), np.asarray(jargs))


def ellipse(H, W, a, b):
    yy, xx = np.mgrid[0:H, 0:W]
    return (((xx - W / 2) / a) ** 2 + ((yy - H / 2) / b) ** 2 < 1)


@pytest.mark.parametrize("k", [16, 64])
def test_match_boundaries_equal(k):
    smpl = JC.trace_boundary(disk(128, 128, 64, 64, 40))
    rgb = JC.simplify(JC.trace_boundary(ellipse(128, 128, 52, 30)))
    want = JB.match_boundaries(smpl, rgb, k=k)
    got = TB.match_boundaries(smpl, rgb, k=k, device="cpu")
    assert got.dtype == np.int64 and got.shape == (rgb.shape[0],)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all() and got.max() < smpl.shape[0]


def test_match_identical_contours_is_monotone_and_close():
    c = JC.trace_boundary(disk(64, 64, 32, 32, 20))
    got = TB.match_boundaries(c, c, k=8, device="cpu")
    np.testing.assert_array_equal(got, JB.match_boundaries(c, c, k=8))
    assert (np.diff(got) >= 1).all()
