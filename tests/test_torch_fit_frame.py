"""fit.smplify.fit_frame against tpubody's, one side-on frame (the host
decides to fit both orientations) with warm-start init_params, at
maxiters=2.  Whole-fit bar: final loss rtol 1e-3; pose, betas, camera
translation and embedding within 1e-3.  tpubody's fit (about 25 s of
compile on the CPU) runs once, in a module-scoped fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_fit_common as common
from tpubody.fit import smplify as js
from tpubody_torch.fit import smplify as ts

torch.set_num_threads(1)

KW = dict(focal_length=common.FOCAL, maxiters=2)


@pytest.fixture(scope="module")
def fits():
    jm, tm = common.models()
    tree = common.decoder_tree()
    kps = common.keypoints(jm, tree)[2]        # side-on: shoulders < 25 px
    rng = np.random.default_rng(12)
    init = {"betas": rng.normal(scale=0.2, size=10).astype(np.float32),
            "pose_embedding": rng.normal(scale=0.2, size=32).astype(
                np.float32),
            "lhand": rng.normal(scale=0.1, size=45).astype(np.float32)}
    dp = jax.tree_util.tree_map(jnp.asarray, tree)
    j = js.fit_frame(jm, kps, common.CENTER, js.FitConfig(**KW),
                     dec_params=dp, init_params=init)
    t = ts.fit_frame(tm, kps, common.CENTER, ts.FitConfig(**KW),
                     dec_params=tree, init_params=init, device="cpu")
    return kps, tm, tree, init, j, t


def test_fit_frame_matches_tpubody(fits):
    kps, _, _, _, j, t = fits
    assert np.linalg.norm(kps[2, :2] - kps[5, :2]) < 25.0
    assert t.pose.shape == (156,) and np.isfinite(t.loss)
    common.hold_fits(j, t)
    np.testing.assert_array_equal(t.camera_rotation, np.eye(3))
    np.testing.assert_array_equal(t.camera_center, common.CENTER)


def test_fit_frame_equals_a_batch_lane_of_one(fits):
    """fit_frame is BatchFitter on one frame (both candidates when the
    host asks for them) with the extra warm starts: without hand inits
    the two agree."""
    kps, tm, tree, init, _, _ = fits
    init = {k: v for k, v in init.items() if k != "lhand"}
    a = ts.fit_frame(tm, kps, common.CENTER, ts.FitConfig(**KW),
                     dec_params=tree, init_params=init, device="cpu")
    b = ts.fit_frames(tm, kps[None], common.CENTER, ts.FitConfig(**KW),
                      dec_params=tree,
                      init_params={k: v[None] for k, v in init.items()},
                      device="cpu")
    np.testing.assert_allclose(a.loss, b.loss[0], rtol=1e-6)
    np.testing.assert_allclose(a.pose, b.pose[0], atol=1e-5)
