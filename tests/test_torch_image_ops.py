"""tpubody_torch.image.ops and render.camera against tpubody's.

``scale_and_crop`` resizes with torch bilinear (align_corners=False, no
antialias); tpubody's default host path uses cv2.INTER_LINEAR on float32.
Both sample at half-pixel centres with two taps per axis.  They compute
the source coordinates in different precision, so a sample lands a few
ulps apart; on uniform-noise images (gradients up to 255 per pixel) that
shows as up to ~1e-2: atol 2e-2 on a 0..255 image, 1e-4 of its range.
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
