"""tpubody_torch.core.skeleton against tpubody.core.skeleton on seeded
numpy inputs.  Both run the same float64 numpy arithmetic on the host, so
every output is held equal bit for bit (tolerance 0)."""
import numpy as np
import pytest

from tpubody.core import skeleton as JK
from tpubody.models import params as jparams
from tpubody_torch.core import skeleton as TK
from tpubody_torch.models import params as tparams


def rest_joints(seed):
    """Zero-pose joints of the seeded synthetic SMPL (24 joints), shaped."""
    raw = tparams.synthetic_numpy(n_joints=24, n_verts=500, seed=seed)
    rng = np.random.default_rng(seed)
    beta = rng.normal(scale=0.5, size=10)
    v = raw["v_template"] + raw["shapedirs"] @ beta
    return raw["j_regressor"] @ v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_repose_equals_tpubodys(seed):
    rng = np.random.default_rng(100 + seed)
    rest = rest_joints(seed)
    target = rest + rng.normal(scale=0.05, size=rest.shape)
    pose = rng.normal(scale=0.3, size=(24, 3))
    got = TK.estimate_repose(rest, target, pose, tparams.SMPL_PARENTS)
    want = JK.estimate_repose(rest, target, pose, jparams.SMPL_PARENTS)
    assert got.shape == (24, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_estimate_repose_identity_is_zero():
    rest = rest_joints(0)
    theta = TK.estimate_repose(rest, rest, np.zeros((24, 3)),
                               tparams.SMPL_PARENTS)
    assert np.abs(theta).max() < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_skeleton_motion_and_theta_equal_tpubodys(seed):
    rng = np.random.default_rng(seed)
    rest = rest_joints(seed)
    pose = rng.normal(scale=0.3, size=(24, 3))
    out = []
    for K in (TK, JK):
        sk = K.Skeleton(parents=tparams.SMPL_PARENTS, rest_joints=rest)
        sk.set_motion(np.stack([K._rodrigues_np(p) for p in pose]))
        sk.set_align_propagate(16, K._rodrigues_np(np.array([0, 0, 0.2])))
        sk.set_align_local(4, K._rodrigues_np(np.array([0.1, 0, 0])))
        sk.update_coords()
        out.append((sk.coords.copy(), sk.export_theta(), sk.subtree(13),
                    sk.bone_vector(18)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # set_motion(rodrigues(pose)) then export_theta gives the pose back
    sk = TK.Skeleton(parents=tparams.SMPL_PARENTS, rest_joints=rest)
    sk.set_motion(np.stack([TK._rodrigues_np(p) for p in pose]))
    np.testing.assert_allclose(sk.export_theta(), pose, atol=1e-8)


@pytest.mark.parametrize("rotvec", [
    [0.0, 0.0, 0.0], [1e-9, 0, 0], [0.3, -0.2, 0.5], [np.pi, 0, 0],
    [0, np.pi * (1 - 1e-8), 0], [np.pi / np.sqrt(2), np.pi / np.sqrt(2), 0]])
def test_axis_angle_round_trip_equals_tpubodys(rotvec):
    R = TK._rodrigues_np(np.asarray(rotvec, np.float64))
    np.testing.assert_array_equal(R, JK._rodrigues_np(np.asarray(rotvec)))
    got = TK._mat_to_axis_angle(R)
    np.testing.assert_array_equal(got, JK._mat_to_axis_angle(R))
    if np.linalg.norm(rotvec) < 3.0:   # away from the 180-degree branch
        np.testing.assert_allclose(TK._rodrigues_np(got), R, atol=1e-6)


@pytest.mark.parametrize("flip", [False, True])
def test_align_rotation_equals_tpubodys(flip):
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=3), rng.normal(size=3)
    got = TK._align_rotation(a, b, flip_axis=flip)
    np.testing.assert_array_equal(got, JK._align_rotation(a, b,
                                                          flip_axis=flip))
    if not flip:
        u = got @ (a / np.linalg.norm(a))
        np.testing.assert_allclose(u, b / np.linalg.norm(b), atol=1e-12)
