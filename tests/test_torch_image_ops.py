"""tpubody_torch.image.ops and render.camera against tpubody's.

``scale_and_crop`` resizes with torch bilinear (align_corners=False, no
antialias); tpubody's default host path uses cv2.INTER_LINEAR on float32.
Both sample at half-pixel centres with two taps per axis.  They compute
the source coordinates in different precision, so a sample lands a few
ulps apart; on uniform-noise images (gradients up to 255 per pixel) that
shows as up to ~1e-2: atol 2e-2 on a 0..255 image, 1e-4 of its range.

``resize_image`` (and ``scale_and_crop(host=False)``) is held to
``jax.image.resize``: ``nearest`` equal; the other methods contract each
axis with the same weight matrices (equal to jax's within 3e-7), where
jax's CPU contraction is itself up to ~1.3e-5 of the image's range off
the float64 result at 224^2 and 2e-6 at these 32x28 shapes, the port's
within 4e-7.  Bars: 1e-5 of the range at 32x28, 5e-5 at the crops (the
2.2x shrink to 224^2 reads 1.8e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.image import ops as jops
from tpubody.render import camera as jcam
from tpubody_torch.image import ops as tops
from tpubody_torch.render import camera as tcam

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("hw,center,scale,size", [
    ((300, 260, 3), (130.0, 150.0), 1.2, 224),   # downsample, inside
    ((120, 90, 3), (45.0, 60.0), 0.8, 224),      # upsample + edge padding
    ((64, 64, 3), (10.0, 50.0), 0.5, 64),        # crop past two borders
    ((97, 131, 3), (70.2, 40.7), 0.37, 57),      # odd sizes
    ((500, 500, 3), (250.0, 250.0), 2.5, 224),   # downsample by 2.2
])
def test_scale_and_crop_matches_cv2_path(hw, center, scale, size):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=hw).astype(np.float32)
    want = jops.scale_and_crop(img, center, scale, size)     # cv2 host path
    got = tops.scale_and_crop(img, center, scale, size)
    assert got.shape == want.shape == (size, size, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_normalize_for_hmr():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(2, 16, 16, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tops.normalize_for_hmr(u8),
                                  jops.normalize_for_hmr(u8))
    f = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(tops.normalize_for_hmr(f),
                                  jops.normalize_for_hmr(f))


def test_crop_from_keypoints():
    rng = np.random.default_rng(2)
    kp = np.concatenate([rng.uniform(0, 300, size=(25, 2)),
                         rng.integers(0, 2, size=(25, 1))], axis=1)
    c_t, s_t = tops.crop_from_keypoints(kp)
    c_j, s_j = jops.crop_from_keypoints(kp)
    np.testing.assert_array_equal(c_t, c_j)
    assert s_t == s_j


def test_weak_perspective_translation():
    rng = np.random.default_rng(3)
    cam = rng.normal(size=(5, 3)).astype(np.float32)
    cam[0, 0] = 0.0                                   # the s clamp
    want = np.asarray(jcam.weak_perspective_translation(
        jnp.asarray(cam), 5000.0, 224))
    got = tcam.weak_perspective_translation(torch.tensor(cam), 5000.0, 224)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


RESIZE_METHODS = ("nearest", "linear", "bilinear", "triangle", "cubic",
                  "bicubic", "lanczos3", "lanczos5")


@pytest.mark.parametrize("method", RESIZE_METHODS)
@pytest.mark.parametrize("hw", [(61, 53), (19, 17), (17, 61)],
                         ids=["shrink", "grow", "mixed"])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["HWC", "BHWC"])
def test_resize_image_matches_jax(method, hw, batch):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=batch + hw + (3,)).astype(np.float32)
    want = np.asarray(jops.resize_image(jnp.asarray(img), 32, 28,
                                        method=method))
    got = tops.resize_image(img, 32, 28, method=method, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == batch + (32, 28, 3)
    if method == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * 255)


def test_resize_image_tensor_and_integer_input():
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, size=(23, 31, 3)).astype(np.uint8)
    near = tops.resize_image(torch.as_tensor(u8), 12, 40, method="nearest",
                             device="cpu")
    assert near.dtype == torch.uint8
    np.testing.assert_array_equal(near.numpy(), np.asarray(
        jops.resize_image(jnp.asarray(u8), 12, 40, method="nearest")))
    lin = tops.resize_image(u8, 12, 40, device="cpu")
    want = np.asarray(jops.resize_image(jnp.asarray(u8), 12, 40))
    assert lin.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(lin.numpy(), want, rtol=0, atol=1e-5 * 255)
    with pytest.raises(ValueError, match="method"):
        tops.resize_image(u8, 12, 40, method="area", device="cpu")


@pytest.mark.parametrize("hw,center,scale,size", [
    ((300, 260, 3), (130.0, 150.0), 1.2, 224),   # downsample, inside
    ((120, 90, 3), (45.0, 60.0), 0.8, 224),      # upsample + edge padding
    ((64, 64, 3), (10.0, 50.0), 0.5, 64),        # crop past two borders
    ((97, 131, 3), (70.2, 40.7), 0.37, 57),      # odd sizes
    ((500, 500, 3), (250.0, 250.0), 2.5, 224),   # downsample by 2.2
])
def test_scale_and_crop_device_route_matches(hw, center, scale, size):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=hw).astype(np.float32)
    want = jops.scale_and_crop(img, center, scale, size, host=False)
    got = tops.scale_and_crop(img, center, scale, size, host=False,
                              device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 * 255)
