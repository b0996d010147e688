"""fit.smplify.fit_sequence against tpubody's: a 3-frame clip, chained,
at block 2: a block of two, then a padded tail block warm-started from
it and trimmed by field (block 1 is in test_torch_fit_sequence.py), with
warm budgets under the cap (warm_maxiters 1, warm_cam_maxiters 1) and
the temporal anchor on.  maxiters=2; whole-fit
bar: final loss rtol 1e-3; pose, betas, camera translation and embedding
within 1e-3.  tpubody's fits run once, in a module-scoped fixture (a
compile of most of a minute)."""
import jax
import jax.numpy as jnp
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


BLOCK = 2


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
