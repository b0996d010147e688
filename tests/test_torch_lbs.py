"""tpubody_torch.core.lbs against tpubody.core.lbs (atol 1e-5: fp32 on the
CPU, same contractions in another summation order) and against the
float64 oracle tests/oracle/np_body.py (< 1e-4, the repo's vertex
budget); tpubody_torch.models.smpl against tpubody.models.smpl."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle.np_body import lbs_np
from tpubody.core import lbs as jlbs
from tpubody.models import params as jparams
from tpubody.models import smpl as jsmpl
from tpubody_torch.core import lbs as tlbs
from tpubody_torch.models import params as tparams
from tpubody_torch.models import smpl as tsmpl

torch.set_num_threads(1)

ATOL = 1e-5
ORACLE = 1e-4


@pytest.fixture(scope="module")
def data():
    raw = jparams.synthetic_numpy(n_joints=24, n_verts=300, seed=1)
    jm = jparams.params_from_numpy(raw)
    tm = tparams.params_from_numpy(raw, device="cpu")
    rng = np.random.default_rng(0)
    F = 3
    poses = rng.normal(scale=0.4, size=(F, 24, 3)).astype(np.float32)
    betas = rng.normal(size=(F, 10)).astype(np.float32)
    trans = rng.normal(size=(F, 3)).astype(np.float32)
    return raw, jm, tm, poses, betas, trans


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_make_se3(data):
    rng = np.random.default_rng(1)
    R = rng.normal(size=(4, 3, 3)).astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(tlbs.make_se3(_t(R), _t(t)).numpy(),
                               np.asarray(jlbs.make_se3(_j(R), _j(t))),
                               atol=ATOL)


def test_forward_kinematics_and_remove_rest_pose(data):
    raw, jm, tm, poses, betas, _ = data
    from tpubody.core.rotations import rodrigues

    R = np.asarray(rodrigues(_j(poses[0])))
    joints = np.asarray(raw["j_regressor"] @ raw["v_template"], np.float32)
    Gj = jlbs.forward_kinematics(_j(R), _j(joints), jm.parents)
    Gt = tlbs.forward_kinematics(_t(R), _t(joints), tm.parents)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), atol=ATOL)
    np.testing.assert_allclose(
        tlbs.remove_rest_pose(Gt, _t(joints)).numpy(),
        np.asarray(jlbs.remove_rest_pose(Gj, _j(joints))), atol=ATOL)


def test_affine_inverse_blend_apply(data):
    raw, jm, tm, poses, betas, _ = data
    G_rel = np.asarray(jsmpl.forward(jm, _j(poses[0]), _j(betas[0])).rel_transforms)
    w = raw["weights"].astype(np.float32)
    Tj = jlbs.blend_transforms(_j(w), _j(G_rel))
    Tt = tlbs.blend_transforms(_t(w), _t(G_rel))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=ATOL)
    np.testing.assert_allclose(tlbs.affine_inverse(Tt).numpy(),
                               np.asarray(jlbs.affine_inverse(Tj)), atol=ATOL)
    pts = np.asarray(raw["v_template"], np.float32)
    np.testing.assert_allclose(tlbs.apply_transforms(Tt, _t(pts)).numpy(),
                               np.asarray(jlbs.apply_transforms(Tj, _j(pts))),
                               atol=ATOL)


@pytest.mark.parametrize("rotmat", [False, True])
def test_lbs_batched_matches_tpubody_and_oracle(data, rotmat):
    raw, jm, tm, poses, betas, trans = data
    from tpubody.core.rotations import rodrigues

    pose_in = np.asarray(rodrigues(_j(poses))) if rotmat else poses
    out_t = tlbs.lbs(tm.v_template, tm.shapedirs, tm.posedirs,
                     tm.j_regressor, tm.weights, tm.parents, _t(pose_in),
                     _t(betas), _t(trans), pose_is_rotmat=rotmat)
    for f in range(poses.shape[0]):
        out_j = jlbs.lbs(jm.v_template, jm.shapedirs, jm.posedirs,
                         jm.j_regressor, jm.weights, jm.parents,
                         _j(pose_in[f]), _j(betas[f]), _j(trans[f]),
                         pose_is_rotmat=rotmat)
        for name in out_j._fields:
            np.testing.assert_allclose(getattr(out_t, name)[f].numpy(),
                                       np.asarray(getattr(out_j, name)),
                                       atol=ATOL, err_msg=name)
        ref = lbs_np(raw, poses[f], betas[f], trans[f])
        assert np.abs(out_t.verts[f].numpy() - ref["verts"]).max() < ORACLE
        assert np.abs(out_t.joints_posed[f].numpy()
                      - ref["joints_posed"]).max() < ORACLE
        assert np.abs(out_t.rel_transforms[f].numpy()
                      - ref["G_rel"]).max() < ORACLE


def test_skin_and_skin_batch(data):
    raw, jm, tm, poses, _, trans = data
    joints = np.asarray(raw["j_regressor"] @ raw["v_template"], np.float32)
    vt = np.asarray(raw["v_template"], np.float32)
    w = np.asarray(raw["weights"], np.float32)
    want = np.asarray(jlbs.skin_batch(_j(vt), _j(w), _j(joints), jm.parents,
                                      _j(poses), _j(trans)))
    got = tlbs.skin_batch(_t(vt), _t(w), _t(joints), tm.parents, _t(poses),
                          _t(trans)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    one = tlbs.skin(_t(vt), _t(w), _t(joints), tm.parents, _t(poses[1]),
                    _t(trans[1])).numpy()
    np.testing.assert_allclose(one, want[1], atol=ATOL)


def test_inverse_lbs_round_trip(data):
    raw, jm, tm, poses, betas, trans = data
    st = tsmpl.forward_batch(tm, _t(poses), _t(betas), _t(trans))
    back = tlbs.inverse_lbs(st.verts, tm.weights, st.rel_transforms,
                            _t(trans))
    np.testing.assert_allclose(back.numpy(), st.v_posed.numpy(), atol=ATOL)
    sj = jsmpl.forward(jm, _j(poses[0]), _j(betas[0]), _j(trans[0]))
    want = jlbs.inverse_lbs(sj.verts, jm.weights, sj.rel_transforms,
                            _j(trans[0]))
    np.testing.assert_allclose(back[0].numpy(), np.asarray(want), atol=ATOL)


def test_smpl_forward_batch_and_verts(data):
    raw, jm, tm, poses, betas, trans = data
    want = jsmpl.forward_batch(jm, _j(poses), _j(betas), _j(trans))
    got = tsmpl.forward_batch(tm, _t(poses), _t(betas), _t(trans))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)
    # Shared beta, the throughput API on CPU tensors (torch-op LBS).
    verts = tsmpl.forward_batch_verts(tm, _t(poses), _t(betas[0]), _t(trans))
    want_v = jsmpl.forward_batch_verts(jm, _j(poses), _j(betas[0]),
                                       _j(trans), use_pallas=False)
    np.testing.assert_allclose(verts.numpy(), np.asarray(want_v), atol=ATOL)
    joints = tsmpl.regress_joints(tm, got.verts)
    np.testing.assert_allclose(
        joints.numpy(), np.asarray(jsmpl.regress_joints(jm, want.verts)),
        atol=ATOL)


def test_forward_single_frame(data):
    raw, jm, tm, poses, betas, trans = data
    got = tsmpl.forward(tm, _t(poses[2]), _t(betas[2]), _t(trans[2]))
    want = jsmpl.forward(jm, _j(poses[2]), _j(betas[2]), _j(trans[2]))
    assert got.verts.shape == (300, 3)
    np.testing.assert_allclose(got.verts.numpy(), np.asarray(want.verts),
                               atol=ATOL)
    ref = lbs_np(raw, poses[2], betas[2], trans[2])
    assert np.abs(got.verts.numpy() - ref["verts"]).max() < ORACLE
