"""fit.smplify.BatchFitter / fit_frames against tpubody's, whole fits.

Three frames at maxiters=2 (camera stage + 5 stages, both orientation
candidates of every frame), with side_view_thsh set so that exactly one
frame is side-on: the flipped candidate is selected there and nowhere
else, in both packages.  Whole-fit bar: final loss rtol 1e-3; pose,
betas, camera translation and embedding within 1e-3.  (At maxiters=3 an
fp32 branch of the line search parts the two packages on one of these
lanes: ROADMAP Queue 3, "Sensitivities".)  tpubody's batched fit is
computed once, in a module-scoped fixture: its compile takes most of a
minute on the CPU.
"""
import numpy as np
import pytest
import torch

from tests import torch_fit_common as common
from tpubody.fit import smplify as js
from tpubody_torch.fit import smplify as ts

torch.set_num_threads(1)

KW = dict(focal_length=common.FOCAL, maxiters=2, side_view_thsh=24.5)


@pytest.fixture(scope="module")
def fits():
    jm, tm = common.models()
    tree = common.decoder_tree()
    kps = common.keypoints(jm, tree)
    import jax
    import jax.numpy as jnp
    dp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = js.fit_frames(jm, kps, common.CENTER, js.FitConfig(**KW),
                      dec_params=dp)
    t = ts.fit_frames(tm, kps, common.CENTER, ts.FitConfig(**KW),
                      dec_params=tree, device="cpu")
    return kps, tm, tree, j, t


def test_batch_matches_tpubody(fits):
    kps, _, _, j, t = fits
    assert t.pose.shape == (3, 156) and t.loss.shape == (3,)
    common.hold_fits(j, t)


def test_flip_selected_on_the_side_view_lane_only(fits):
    kps, _, _, j, t = fits
    side = np.linalg.norm(kps[:, 2, :2] - kps[:, 5, :2], axis=1) \
        < KW["side_view_thsh"]
    assert side.tolist() == [False, False, True], side
    for out in (j, t):
        turned = np.abs(out.pose[:, 1]) > 2.0    # about pi around y
        assert turned.tolist() == side.tolist(), out.pose[:, :3]


def test_padding_lanes_change_nothing(fits):
    """Lanes are independent: a batch padded with copies of frame 0 gives
    the same fits (within rounding of another batch size)."""
    kps, tm, tree, _, t = fits
    f = ts.BatchFitter(tm, ts.FitConfig(**KW), dec_params=tree,
                       device="cpu")
    b = f(np.concatenate([kps, kps[:1]]), common.CENTER)
    np.testing.assert_allclose(b.loss[:3], t.loss, rtol=1e-5)
    np.testing.assert_allclose(b.pose[:3], t.pose, atol=1e-4)
    assert set(f.stats) == {"camera", "stages"}
    assert f.stats["stages"]["iterations"] <= 5 * KW["maxiters"]
    cam_ms, stages_ms = f.split_ms()
    assert cam_ms > 0 and stages_ms > 0


def test_apply_returns_lane_tensors(fits):
    kps, tm, tree, _, t = fits
    f = ts.BatchFitter(tm, ts.FitConfig(**KW), dec_params=tree,
                       device="cpu")
    out = f.apply(torch.as_tensor(kps),
                  torch.as_tensor(np.tile(common.CENTER, (3, 1))))
    assert set(out) == {"pose", "shape", "cam_t", "emb", "loss",
                        "expression"}
    np.testing.assert_allclose(out["loss"].numpy(), t.loss, rtol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tm = common.models()
    kps = np.zeros((1, 67, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.BatchFitter(tm)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.fit_frames(tm, kps, common.CENTER)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.fit_frame(tm, kps[0], common.CENTER)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.fit_sequence(tm, kps, common.CENTER)
