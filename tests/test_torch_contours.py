"""tpubody_torch.image.contours against tpubody.image.contours: host
numpy on both sides, integer outputs, so everything is equal.  tpubody's
tracer uses its C++ library where that is built; both are also held to
tpubody's Python tracer, the behavioural reference."""
import numpy as np
import pytest

from tpubody import native as jnative
from tpubody.image import contours as JC
from tpubody_torch.image import contours as TC

from tests.test_torch_morphology import blob_mask


def disk(H, W, cx, cy, r):
    yy, xx = np.mgrid[0:H, 0:W]
    return ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r).astype(np.uint8) * 255


def masks():
    out = {"disk": disk(64, 64, 32, 32, 18),
           "disk touching the border": disk(48, 64, 5, 40, 14),
           "blobs": blob_mask(64, 128, 0),
           "one pixel": np.pad(np.ones((1, 1), bool), 3),
           "thin line": np.pad(np.ones((1, 9), bool), 2),
           "empty": np.zeros((8, 8), bool)}
    rect = np.zeros((20, 30), bool)
    rect[4:15, 6:25] = True
    out["rectangle"] = rect
    return out


MASKS = masks()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_trace_boundary_equal(name, monkeypatch):
    m = MASKS[name]
    got = TC.trace_boundary(m)
    np.testing.assert_array_equal(got, JC.trace_boundary(m))
    monkeypatch.setattr(jnative, "trace_boundary", lambda mask: None)
    np.testing.assert_array_equal(got, JC.trace_boundary(m))
    assert got.dtype == np.int64 and got.shape[1] == 2


@pytest.mark.parametrize("name", ["disk", "blobs", "rectangle", "thin line"])
def test_simplify_subsample_inner_points_equal(name):
    m = MASKS[name]
    c = TC.trace_boundary(m)
    np.testing.assert_array_equal(TC.simplify(c), JC.simplify(c))
    for eps in (1.0, 0.5, 0.13):
        np.testing.assert_array_equal(TC.subsample(c, eps),
                                      JC.subsample(c, eps))
    np.testing.assert_array_equal(TC.inner_points(m), JC.inner_points(m))


def test_rectangle_simplifies_to_its_corners():
    c = TC.simplify(TC.trace_boundary(MASKS["rectangle"]))
    assert c.shape[0] == 4
    assert TC.simplify(c[:2]).shape[0] == 2      # too short: passed through
