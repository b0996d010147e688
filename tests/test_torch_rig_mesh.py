"""tpubody_torch.mesh.rigging's rig_mesh, align_mesh_to_smpl and
inverse_lbs_np against tpubody.mesh.rigging.

``rig_mesh`` is fed tpubody's stitch result on its device stages' outputs
(tests/torch_recon_common.py, the 1100-vertex humanoid at 128x128).  The
three SMPL forwards that feed it run in float32 in both packages (torch
ops here, XLA there), and the repose and the inverse LBS in float64 on
the host, so the float32 forwards' last bits reach the avatar: v_template
and the T-pose joints are held within 1e-6 (measured 4.9e-8 and 7.2e-8;
BASELINE.json's vertex bar is 1e-4), or_pose within 1e-5 (measured
4.1e-7), and the weights, colours and faces, which no forward touches,
equal.  align_mesh_to_smpl and inverse_lbs_np are float64 numpy in both:
equal (tolerance 0)."""
import numpy as np
import pytest
import torch

from tpubody.mesh import rigging as JRig
from tpubody.mesh import stitch as JSt
from tpubody.models import params as jparams
from tpubody_torch.core import lbs as tlbs
from tpubody_torch.mesh import rigging as TRig
from tpubody_torch.models import humanoid as TH
from tpubody_torch.models import params as tparams
from tpubody_torch.models import smpl as tsmpl

from tests import torch_recon_common as C

torch.set_num_threads(1)

V_ATOL = 1e-6          # v_template and joints (m)
POSE_ATOL = 1e-5       # or_pose (rad)


@pytest.fixture(scope="module")
def stitched():
    jc = C.jax_chain_data()
    mp = pytest.MonkeyPatch()
    C.use_native_geometry(mp)
    try:
        res = JSt.stitch_mesh(*C.stitch_inputs(jc))
    finally:
        mp.undo()
    return jc, res


def rig_args(jc, res):
    return (res.points[:, :3], res.points[:, 3:6], res.faces,
            res.points[:, 6:30], jc["fit"].pose.reshape(-1, 3)[:24],
            jc["fit"].shape, res.joints3d)


def assert_avatars_close(got, want):
    np.testing.assert_allclose(got.v_template, want.v_template, atol=V_ATOL)
    np.testing.assert_allclose(got.joints, want.joints, atol=V_ATOL)
    np.testing.assert_allclose(got.or_pose, want.or_pose, atol=POSE_ATOL)
    for k in ("weights", "color", "faces", "or_shape"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.parents == tuple(want.parents)
    for k in ("v_template", "weights", "color", "joints", "or_pose"):
        assert getattr(got, k).dtype == np.float64, k


def test_rig_mesh_on_tpubodys_stitch(stitched):
    jc, res = stitched
    want = JRig.rig_mesh(jc["smpl"], *rig_args(jc, res))
    got = TRig.rig_mesh(TH.humanoid(24, C.N_VERTS, device="cpu"),
                        *rig_args(jc, res))
    assert_avatars_close(got, want)
    np.testing.assert_allclose(got.weights.sum(axis=1), 1.0, atol=1e-12)
    assert got.v_template.shape == (res.points.shape[0], 3)


def test_rig_smpl_itself_roundtrip():
    """tests/test_rigging.py's case on both packages: rig the SMPL's own
    posed mesh at a leg-only pose, skinning the avatar with or_pose lands
    near the aligned input (that file's 0.15 x scale), and the two
    avatars agree."""
    rng = np.random.default_rng(3)
    pose = np.zeros((24, 3))
    pose[[1, 2, 4, 5]] = rng.normal(scale=0.25, size=(4, 3))
    shape = rng.normal(scale=0.5, size=(10,))
    tmodel = tparams.synthetic(n_joints=24, n_verts=500, seed=4,
                               device="cpu")
    jmodel = jparams.synthetic(n_joints=24, n_verts=500, seed=4)
    posed = tsmpl.forward(tmodel, torch.as_tensor(pose, dtype=torch.float32),
                          torch.as_tensor(shape, dtype=torch.float32))
    verts = posed.verts.numpy().astype(np.float64)
    joints = posed.joints_posed.numpy().astype(np.float64)
    weights = tmodel.weights.numpy().astype(np.float64)
    color = np.full_like(verts, 128.0)
    args = (verts, color, tmodel.faces, weights, pose, shape, joints)
    got = TRig.rig_mesh(tmodel, *args)
    assert_avatars_close(got, JRig.rig_mesh(jmodel, *args))
    out = TRig.animate(got, got.or_pose[None], device="cpu")[0].numpy()
    aligned, _ = TRig.align_mesh_to_smpl(verts, verts, joints, joints)
    assert np.abs(out - aligned).mean() < 0.15 * verts.std()


@pytest.mark.parametrize("seed", [0, 1])
def test_align_mesh_to_smpl_equals_tpubodys(seed):
    rng = np.random.default_rng(seed)
    sv = rng.normal(size=(100, 3))
    v = (sv * 250.0 + 40.0).astype(np.float32)
    sJ = rng.normal(size=(24, 3)) * 0.2
    J = sJ * 250.0 + 40.0
    got = TRig.align_mesh_to_smpl(sv, v, sJ, J)
    for a, b in zip(got, JRig.align_mesh_to_smpl(sv, v, sJ, J)):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1][0], sJ[0], atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_lbs_np_equals_tpubodys_and_the_device_inverse(seed):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    V, J = 300, 24
    weights = rng.dirichlet(np.ones(J), size=V)
    G = np.tile(np.eye(4), (J, 1, 1))
    G[:, :3, :3] = Rotation.from_rotvec(
        0.4 * rng.normal(size=(J, 3))).as_matrix()
    G[:, :3, 3] = 0.2 * rng.normal(size=(J, 3))
    rest = rng.normal(size=(V, 3))
    T = (weights @ G.reshape(J, 16)).reshape(V, 4, 4)
    posed = np.einsum("vij,vj->vi", T[:, :3, :3], rest) + T[:, :3, 3]
    got = TRig.inverse_lbs_np(posed, weights, G)
    np.testing.assert_array_equal(got, JRig.inverse_lbs_np(posed, weights,
                                                           G))
    np.testing.assert_allclose(got, rest, atol=1e-9)
    # the port's float32 torch inverse (core.lbs) on the same input
    dev = tlbs.inverse_lbs(torch.as_tensor(posed, dtype=torch.float32),
                           torch.as_tensor(weights, dtype=torch.float32),
                           torch.as_tensor(G, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, dev, atol=5e-5)


def test_avatar_from_numpy_takes_tpubodys_avatar(stitched, tmp_path):
    """The converter, and the avatar pickle read by either package."""
    jc, res = stitched
    javatar = JRig.rig_mesh(jc["smpl"], *rig_args(jc, res))
    tavatar = TRig.avatar_from_numpy(**javatar._asdict())
    assert type(tavatar) is TRig.RiggedAvatar
    assert tavatar._fields == javatar._fields
    for a, b in zip(tavatar, javatar):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    TRig.save_avatar(str(tmp_path / "t.pkl"), tavatar)
    JRig.save_avatar(str(tmp_path / "j.pkl"), javatar)
    # the schema keeps no or_shape: both loaders give zeros
    for got in (JRig.load_avatar(str(tmp_path / "t.pkl")),
                TRig.load_avatar(str(tmp_path / "j.pkl"))):
        for k in javatar._fields:
            want = (np.zeros(10) if k == "or_shape"
                    else np.asarray(getattr(javatar, k)))
            np.testing.assert_array_equal(np.asarray(getattr(got, k)), want)
