"""tpubody_torch.image.morphology against tpubody.image.morphology on
seeded numpy images (64x128 and an odd 37x53), on the CPU.

Tolerances: min/max filters, their compositions and the median select
values, so they are equal; the box filter sums k^2 float32 values in
another order than XLA's convolution, so box_blur and masked_box_smooth
are held to 1e-6 on inputs in [0, 1]."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.image import morphology as JM
from tpubody_torch.image import morphology as TM

torch.set_num_threads(1)
BOX_ATOL = 1e-6


def blob_mask(H, W, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    m = np.zeros((H, W), bool)
    for _ in range(6):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        r = rng.uniform(3, H / 3)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    m ^= rng.random((H, W)) < 0.02          # salt and pepper
    return m


SIZES = [(64, 128, 0), (37, 53, 1)]


@pytest.mark.parametrize("H,W,seed", SIZES)
@pytest.mark.parametrize("name", ["erode", "dilate", "close", "open_",
                                  "boundary"])
@pytest.mark.parametrize("ksize", [3, 5])
def test_binary_ops_equal(name, ksize, H, W, seed):
    m = blob_mask(H, W, seed)
    m[0, :7] = True                       # touches the border: +-inf padding
    m[-1, -9:] = True
    want = np.asarray(getattr(JM, name)(jnp.asarray(m), ksize))
    got = getattr(TM, name)(torch.as_tensor(m), ksize)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_border_does_not_erode():
    m = np.ones((16, 24), bool)
    assert TM.erode(torch.as_tensor(m), 5).all()
    assert np.asarray(JM.erode(jnp.asarray(m), 5)).all()


@pytest.mark.parametrize("name", ["erode", "dilate"])
def test_greyscale_keeps_dtype_and_values(name):
    x = np.random.default_rng(2).random((32, 48)).astype(np.float32)
    want = np.asarray(getattr(JM, name)(jnp.asarray(x), 3))
    got = getattr(TM, name)(torch.as_tensor(x), 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("H,W,seed", SIZES)
@pytest.mark.parametrize("channels", [None, 1, 7])
@pytest.mark.parametrize("ksize", [3, 5])
def test_box_blur(ksize, channels, H, W, seed):
    rng = np.random.default_rng(seed)
    shape = (H, W) if channels is None else (H, W, channels)
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(JM.box_blur(jnp.asarray(x), ksize))
    got = TM.box_blur(torch.as_tensor(x), ksize).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BOX_ATOL)
    # zero padding, divided by k^2: a corner of ones keeps (k//2 + 1)^2/k^2
    ones = TM.box_blur(torch.ones(H, W), ksize)
    assert abs(float(ones[0, 0]) - (ksize // 2 + 1) ** 2 / ksize ** 2) < 1e-6


def test_box_blur_is_fp32_whatever_the_tf32_flags_say():
    """The filter must not be a convolution that a global flag can lower
    to TF32 on the card; here the flags are set and the result is the
    same."""
    x = torch.as_tensor(np.random.default_rng(3).random((32, 48, 4))
                        .astype(np.float32))
    want = TM.box_blur(x, 3)
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(TM.box_blur(x, 3), want)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("H,W,seed", SIZES)
@pytest.mark.parametrize("channels", [None, 3, 11])
@pytest.mark.parametrize("ksize", [3, 5])
def test_median_blur_equal(ksize, channels, H, W, seed):
    """11 channels: more than one group of channels is sorted."""
    rng = np.random.default_rng(seed + 10)
    shape = (H, W) if channels is None else (H, W, channels)
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(JM.median_blur(jnp.asarray(x), ksize))
    got = TM.median_blur(torch.as_tensor(x), ksize).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 6])
def test_masked_box_smooth(channels):
    rng = np.random.default_rng(5)
    H, W = 64, 128
    shape = (H, W) if channels is None else (H, W, channels)
    x = rng.random(shape).astype(np.float32)
    m = blob_mask(H, W, 4)
    want = np.asarray(JM.masked_box_smooth(jnp.asarray(x), jnp.asarray(m), 3))
    got = TM.masked_box_smooth(torch.as_tensor(x), torch.as_tensor(m), 3)
    # where no valid pixel is in reach both divide 0 by the 1e-8 floor
    np.testing.assert_allclose(got.numpy(), want, atol=BOX_ATOL, rtol=1e-6)
