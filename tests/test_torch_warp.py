"""tpubody_torch.image.warp against tpubody.image.warp on the CPU, at
64x64 and 64x128.

Tolerances:
  * scatter_warp: values are copied, so equal at EVERY pixel, pixels hit
    by several sources included: there tpubody on the CPU keeps the last
    source in order (XLA:CPU applies the updates one after another), and
    the port keeps the same one by rule;
  * fill_holes_pyramid: 1e-6 (2x2 sums of float32 in another order);
  * fill_holes: 1e-5 and the same iteration count (up to 512 box-filter
    passes, each within 1e-6, averaged, not accumulated);
  * the smoothing passes: 1e-6 (box filter), medians select;
  * warp_stage, disk -> ellipse (tests/test_warp.py): contours and match
    equal; raw scatter equal except where a warped position lands within
    float32 rounding of a pixel boundary (none on this case); value within
    1e-4."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.image import warp as JW
from tpubody_torch.image import warp as TW

from tests.test_torch_contours import disk
from tests.test_torch_morphology import blob_mask

torch.set_num_threads(1)


def t(x):
    return torch.as_tensor(x)


def value_map(src_mask, channels=30, seed=0):
    """A value map like the renderer's: background 1.0, smooth normals in
    the first six channels, positive weights that sum to 1 after them."""
    rng = np.random.default_rng(seed)
    H, W = src_mask.shape
    yy, xx = np.mgrid[0:H, 0:W] / float(max(H, W))
    value = np.ones((H, W, channels), np.float32)
    m = src_mask > 0
    for c in range(min(6, channels)):
        plane = 0.2 + 0.6 * (np.sin(3 * xx + c) * np.cos(2 * yy - c) + 1) / 2
        value[..., c][m] = plane[m]
    if channels > 6:
        w = rng.random((H, W, channels - 6)).astype(np.float32) ** 4
        w /= w.sum(-1, keepdims=True)
        value[..., 6:][m] = w[m]
    return value.astype(np.float32)


def test_silhouette_from_value():
    src = disk(64, 64, 32, 32, 18)
    v = value_map(src)
    v[10, 10, 0:3] = [1.0, 1.0, 0.5]       # front not clear, back clear
    v[20, 20, 3:6] = 1.0                   # inside, back clear -> background
    want = np.asarray(JW.silhouette_from_value(jnp.asarray(v)))
    got = TW.silhouette_from_value(t(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[20, 20] and not got[10, 10] and got[32, 32]


def test_scatter_warp_equal_with_duplicate_destinations():
    """600 sources onto a 20x30 patch: most destinations are hit several
    times, some are out of bounds and clipped onto the border."""
    rng = np.random.default_rng(3)
    H, W = 32, 48
    value = rng.random((H, W, 5)).astype(np.float32)
    src = np.stack([rng.integers(0, W, 600), rng.integers(0, H, 600)], 1)
    dst = np.stack([rng.uniform(-3, 27, 600), rng.uniform(10, 35, 600)], 1
                   ).astype(np.float32)
    dst[:40] = np.floor(dst[:40]) + 0.5    # ties of round-half-even
    want = np.asarray(JW.scatter_warp(jnp.asarray(value), jnp.asarray(src),
                                      jnp.asarray(dst)))
    got = TW.scatter_warp(t(value), t(src), t(dst)).numpy()
    lin = (np.clip(np.round(dst[:, 1]), 0, H - 1) * W
           + np.clip(np.round(dst[:, 0]), 0, W - 1))
    assert np.unique(lin).size < 450       # the case does have duplicates
    np.testing.assert_array_equal(got, want)
    # the rule, stated: the last source in order owns the pixel
    last = {int(p): i for i, p in enumerate(lin)}
    for p, i in list(last.items())[:50]:
        np.testing.assert_array_equal(got.reshape(-1, 5)[p],
                                      value[src[i, 1], src[i, 0]])


def holes_case(H, W, seed, keep=0.6, channels=8):
    rng = np.random.default_rng(seed)
    mask = blob_mask(H, W, seed)
    value = value_map(mask.astype(np.uint8), channels, seed)
    seeds = mask & (rng.random((H, W)) < keep)
    return np.where(seeds[..., None], value, 0.0).astype(np.float32), mask


@pytest.mark.parametrize("H,W,seed", [(64, 128, 0), (37, 53, 1), (64, 64, 2)])
def test_fill_holes_pyramid(H, W, seed):
    value, mask = holes_case(H, W, seed)
    want = np.asarray(JW.fill_holes_pyramid(jnp.asarray(value),
                                            jnp.asarray(mask)))
    got = TW.fill_holes_pyramid(t(value), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (np.abs(got[mask]).sum(-1) > 0).all()
    np.testing.assert_array_equal(got[~mask], value[~mask])


@pytest.mark.parametrize("H,W,seed,keep", [(64, 128, 0, 0.6),
                                            (64, 64, 2, 0.02)])
def test_fill_holes_diffusion_same_iterations(H, W, seed, keep):
    value, mask = holes_case(H, W, seed, keep)
    jimg, jit_ = JW._fill_holes_full(jnp.asarray(value), jnp.asarray(mask))
    img, it = TW._fill_holes_full(t(value), t(mask))
    assert it == int(jit_) and it >= (1 if keep > 0.5 else 4)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)
    np.testing.assert_allclose(TW.fill_holes(t(value), t(mask)).numpy(),
                               img.numpy())
    _, it3 = TW._fill_holes_full(t(value), t(mask), max_iters=3)
    assert it3 == min(3, it)


def test_smoothing_passes():
    value, mask = holes_case(64, 128, 4, keep=1.0, channels=30)
    want = np.asarray(JW.smooth_filled(jnp.asarray(value), jnp.asarray(mask)))
    got = TW.smooth_filled(t(value), t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    want = np.asarray(JW.smooth_weight_channels(jnp.asarray(value)))
    got = TW.smooth_weight_channels(t(value)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[..., :6], value[..., :6])


def ellipse_mask(H, W, a, b):
    yy, xx = np.mgrid[0:H, 0:W]
    return ((((xx - W // 2) / a) ** 2 + ((yy - H // 2) / b) ** 2) < 1
            ).astype(np.uint8) * 255


@pytest.mark.parametrize("fill,channels", [("pyramid", 30), ("diffusion", 8)])
def test_warp_stage_disk_to_ellipse(fill, channels):
    H = W = 64
    src_mask = disk(H, W, 32, 32, 18)
    dst_mask = ellipse_mask(H, W, 24.0, 14.0)
    value = value_map(src_mask, channels)
    want = JW.warp_stage(dst_mask, value, fill=fill)
    got = TW.warp_stage(dst_mask, value, fill=fill, device="cpu")
    np.testing.assert_array_equal(got.smpl_bound, want.smpl_bound)
    np.testing.assert_array_equal(got.rgb_bound, want.rgb_bound)
    np.testing.assert_array_equal(got.match, want.match)
    np.testing.assert_array_equal(got.warped_raw.numpy(),
                                  np.asarray(want.warped_raw))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               atol=1e-4)
    out, m = got.value.numpy(), dst_mask > 0
    assert (np.abs(out[m]).sum(-1) > 0).mean() > 0.99
    assert (out[~m] == 0).all()
    assert out[..., 0][m].min() >= 0.0 and out[..., 0][m].max() <= 1.0 + 1e-5


def test_warp_stage_takes_a_tensor_and_a_timer():
    from tpubody_torch.utils.profiling import StageTimer

    src_mask = disk(64, 64, 32, 32, 18)
    dst_mask = ellipse_mask(64, 64, 24.0, 14.0)
    value = value_map(src_mask, 8)
    timer = StageTimer()
    a = TW.warp_stage(dst_mask, t(value), timer=timer, fill="diffusion")
    b = TW.warp_stage(dst_mask, value, device="cpu", fill="diffusion")
    assert torch.equal(a.value, b.value)
    names = [r["stage"] for r in timer.records]
    assert names == ["warp/to_device", "warp/silhouette", "warp/contours",
                     "warp/match", "warp/inner_points", "warp/mvc",
                     "warp/scatter", "warp/fill_holes_iters",
                     "warp/fill_holes", "warp/smooth"]
    assert "TOTAL" in timer.report()


def test_warp_stage_rejects_a_degenerate_silhouette():
    value = value_map(disk(64, 64, 32, 32, 18), 8)
    with pytest.raises(ValueError, match="degenerate silhouette"):
        TW.warp_stage(np.zeros((64, 64), np.uint8), value, device="cpu")
