"""tpubody_torch.io.asf against tpubody.io.asf: every case of
tests/test_asf.py, on its SAMPLE_ASF / SAMPLE_AMC text, held to
``tpubody``'s outputs.  Both are the same numpy code in float64: equal
bit for bit."""
import numpy as np
import pytest
import torch

from tests.test_asf import SAMPLE_AMC, SAMPLE_ASF
from tpubody.io import asf as jasf
from tpubody_torch.io import asf as tasf

NO_LIMITS = SAMPLE_ASF.replace("    dof rx\n    limits (-10.0 170.0)\n",
                               "    dof rx rz\n")
ROOT_ORDER = SAMPLE_ASF.replace("order TX TY TZ RX RY RZ",
                                "order RZ RY RX TZ TY TX")
AMC_2DOF = SAMPLE_AMC.replace("ltibia 30.0", "ltibia 30.0 15.0").replace(
    "ltibia 35.0", "ltibia 35.0 17.0")
RADIANS = SAMPLE_AMC.replace(":DEGREES", ":RADIANS")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("asf", [SAMPLE_ASF, NO_LIMITS, ROOT_ORDER])
def test_parse_asf(asf):
    want, got = jasf.parse_asf(asf), tasf.parse_asf(asf)
    assert got.name_to_index == want.name_to_index
    assert got.root_order == want.root_order
    assert got.length_scale == want.length_scale
    for g, w in zip(got.bones, want.bones):
        assert (g.name, g.dof, g.parent, g.length) == \
            (w.name, w.dof, w.parent, w.length)
        for f in ("direction", "C", "Cinv", "limits"):
            _eq(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("amc", [SAMPLE_AMC, AMC_2DOF, RADIANS])
def test_parse_amc(amc):
    want, got = jasf.parse_amc(amc), tasf.parse_amc(amc)
    assert got.degrees == want.degrees and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            _eq(g[k], w[k])


@pytest.mark.parametrize("asf,amc", [(SAMPLE_ASF, SAMPLE_AMC),
                                     (NO_LIMITS, AMC_2DOF),
                                     (ROOT_ORDER, SAMPLE_AMC),
                                     (SAMPLE_ASF, RADIANS)])
def test_frame_angles_fk_and_retarget(asf, amc):
    js, ts = jasf.parse_asf(asf), tasf.parse_asf(asf)
    jf, tf = jasf.parse_amc(amc), tasf.parse_amc(amc)
    for w, g in zip(jasf._frame_angles(js, jf), tasf._frame_angles(ts, tf)):
        _eq(g, w)
    for w, g in zip(jasf.fk(js, jf), tasf.fk(ts, tf)):
        _eq(g, w)
    want = jasf.retarget_to_smpl(js, jf, fps=60.0, stride=1)
    got = tasf.retarget_to_smpl(ts, tf, fps=60.0, stride=1)
    _eq(got.poses, want.poses)
    _eq(got.trans, want.trans)
    assert got.fps == want.fps == 60.0


def test_zero_motion_gives_identity_poses():
    frames = [{"root": np.zeros(6), "lfemur": np.zeros(3),
               "ltibia": np.zeros(1)}]
    clip = tasf.retarget_to_smpl(tasf.parse_asf(SAMPLE_ASF), frames)
    want = jasf.retarget_to_smpl(jasf.parse_asf(SAMPLE_ASF), frames)
    _eq(clip.poses, want.poses)
    np.testing.assert_allclose(clip.poses, 0.0, atol=1e-12)


def test_read_amc_and_stride(tmp_path):
    asf_p, amc_p = tmp_path / "skel.asf", tmp_path / "clip.amc"
    asf_p.write_text(SAMPLE_ASF)
    amc_p.write_text(SAMPLE_AMC)
    for stride in (1, 2):
        want = jasf.read_amc(str(asf_p), str(amc_p), fps=120.0,
                             stride=stride)
        got = tasf.read_amc(str(asf_p), str(amc_p), fps=120.0,
                            stride=stride)
        assert got.poses.shape == want.poses.shape == (2 // stride, 24, 3)
        _eq(got.poses, want.poses)
        _eq(got.trans, want.trans)


def test_malformed_skeletons_raise():
    with pytest.raises(ValueError, match="ltibia"):
        tasf.parse_asf(SAMPLE_ASF.replace("    lfemur ltibia\n", ""))
    with pytest.raises(ValueError, match="root order"):
        tasf.parse_asf(SAMPLE_ASF.replace("order TX TY TZ RX RY RZ",
                                          "order TX TY TZ RX RY L"))


def test_clip_drives_lbs_forward():
    from tpubody_torch.models import params as tparams
    from tpubody_torch.models import smpl as tsmpl

    clip = tasf.retarget_to_smpl(tasf.parse_asf(SAMPLE_ASF),
                                 tasf.parse_amc(SAMPLE_AMC))
    body = tparams.synthetic(n_joints=24, n_verts=128, seed=0)
    verts = tsmpl.forward_batch_verts(
        body, torch.as_tensor(clip.poses, dtype=torch.float32),
        torch.zeros(10))
    assert verts.shape == (2, 128, 3) and torch.isfinite(verts).all()
