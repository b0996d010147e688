"""fit.smplify.fit_sequence against tpubody's: a 3-frame clip, chained,
at block 1 (frame-to-frame warm starts; block 2 is in
test_torch_fit_sequence_block.py), with warm budgets under the cap
(warm_maxiters 1, warm_cam_maxiters 1) and the temporal anchor on.  maxiters=2; whole-fit
bar: final loss rtol 1e-3; pose, betas, camera translation and embedding
within 1e-3.  tpubody's fits run once, in a module-scoped fixture (a
compile of most of a minute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_fit_common as common
from tpubody.fit import smplify as js
from tpubody_torch.fit import smplify as ts

torch.set_num_threads(1)

KW = dict(focal_length=common.FOCAL, maxiters=2, warm_maxiters=1,
          warm_cam_maxiters=1, temporal_weight=1.0)


@pytest.fixture(scope="module")
def clip():
    jm, tm = common.models()
    tree = common.decoder_tree()
    kps = common.keypoints(jm, tree, drift=0.05)
    return jm, tm, tree, kps


BLOCK = 1


@pytest.fixture(scope="module")
def fits(clip):
    jm, tm, tree, kps = clip
    dp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = js.fit_sequence(jm, kps, common.CENTER, js.FitConfig(**KW),
                        dec_params=dp, block=BLOCK)
    t = ts.fit_sequence(tm, kps, common.CENTER, ts.FitConfig(**KW),
                        dec_params=tree, block=BLOCK, device="cpu")
    return BLOCK, j, t


def test_sequence_matches_tpubody(fits):
    block, j, t = fits
    for f in ts.FRAME_FIELDS:
        if getattr(t, f) is not None:
            assert getattr(t, f).shape[0] == 3, (block, f)
    common.hold_fits(j, t)


def test_trim_frames_by_field():
    """A padded batch output is trimmed field by field, whatever sizes
    its other axes have (a 10-wide shape is not mistaken for frames)."""
    n = 10
    out = ts.FitBatchOutput(
        pose=np.zeros((n, 156)), shape=np.zeros((n, 10)),
        camera_translation=np.zeros((n, 3)), camera_center=np.zeros((n, 2)),
        camera_fx=5000.0, pose_embedding=np.zeros((n, 32)),
        loss=np.zeros(n), expression=None)
    cut = ts.trim_frames(out, 7)
    assert cut.pose.shape == (7, 156) and cut.shape.shape == (7, 10)
    assert cut.loss.shape == (7,) and cut.camera_fx == 5000.0
    assert cut.expression is None
