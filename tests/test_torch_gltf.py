"""tpubody_torch.mesh.gltf against tpubody.mesh.gltf: for the same avatar
(and the same static mesh) either package writes the same GLB, byte for
byte, and each package's read_glb / read_accessor reads the other's file
back to the same accessors (tolerance 0).  The port's skinned GLB,
evaluated by tests/test_gltf.py's independent glTF interpreter, follows
the port's own ``rigging.animate`` within that file's 2e-5."""
import numpy as np
import pytest

from tpubody.mesh import gltf as JGl
from tpubody.mesh import rigging as JRig
from tpubody_torch.mesh import gltf as TGl
from tpubody_torch.mesh import rigging as TRig
from tpubody_torch.models import params as tparams

from tests.test_gltf import _eval_skinned_gltf


def avatar(seed=0, n_verts=300):
    """A seeded avatar from the synthetic SMPL's numpy arrays, as both
    packages' RiggedAvatar."""
    raw = tparams.synthetic_numpy(n_joints=24, n_verts=n_verts, seed=seed)
    rng = np.random.default_rng(seed)
    fields = dict(
        v_template=raw["v_template"], weights=raw["weights"],
        color=rng.uniform(0, 1, (n_verts, 3)),
        faces=np.asarray(raw["faces"], np.int64),
        joints=raw["j_regressor"] @ raw["v_template"],
        parents=tuple(raw["parents"]), or_pose=np.zeros((24, 3)),
        or_shape=np.zeros(10))
    return TRig.RiggedAvatar(**fields), JRig.RiggedAvatar(**fields)


def read_all(reader, path):
    gltf, blob = reader.read_glb(path)
    return gltf, [reader.read_accessor(gltf, blob, i)
                  for i in range(len(gltf["accessors"]))]


def assert_same_file(p_t, p_j):
    raw = open(p_t, "rb").read()
    assert raw == open(p_j, "rb").read()
    assert len(raw) % 4 == 0
    # each package reads the other's file to the same accessors
    for reader, path in ((JGl, p_t), (TGl, p_j)):
        g_a, acc_a = read_all(reader, path)
        g_b, acc_b = read_all(TGl if reader is JGl else JGl, path)
        assert g_a == g_b
        for a, b in zip(acc_a, acc_b):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clip", ["rest", "none", "poses", "poses+trans"])
@pytest.mark.parametrize("influences", [8, 24])
def test_avatar_glb_equals_tpubodys(tmp_path, clip, influences):
    t_av, j_av = avatar(seed=1)
    rng = np.random.default_rng(7)
    kw = {"max_influences": influences}
    if clip == "rest":
        kw["poses"] = np.zeros((1, 24, 3))
    elif clip != "none":
        kw["poses"] = rng.normal(scale=0.4, size=(3, 24, 3))
        kw["fps"] = 24.0
        if clip == "poses+trans":
            kw["trans"] = rng.normal(scale=0.2, size=(3, 3))
    TGl.export_avatar_glb(str(tmp_path / "t.glb"), t_av, **kw)
    JGl.export_avatar_glb(str(tmp_path / "j.glb"), j_av, **kw)
    assert_same_file(str(tmp_path / "t.glb"), str(tmp_path / "j.glb"))


@pytest.mark.parametrize("with_colors", [False, True])
def test_static_glb_equals_tpubodys(tmp_path, with_colors):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, (9, 3)).astype(np.int64)
    colors = rng.uniform(0, 255, (17, 3)) if with_colors else None
    TGl.export_glb(str(tmp_path / "t.glb"), verts, faces, colors)
    JGl.export_glb(str(tmp_path / "j.glb"), verts, faces, colors)
    assert_same_file(str(tmp_path / "t.glb"), str(tmp_path / "j.glb"))
    gltf, blob = TGl.read_glb(str(tmp_path / "t.glb"))
    prim = gltf["meshes"][0]["primitives"][0]
    np.testing.assert_array_equal(
        TGl.read_accessor(gltf, blob, prim["attributes"]["POSITION"]), verts)


def test_skinned_glb_follows_the_ports_animate(tmp_path):
    t_av, _ = avatar(seed=1)
    rng = np.random.default_rng(7)
    poses = rng.normal(scale=0.4, size=(3, 24, 3))
    trans = rng.normal(scale=0.2, size=(3, 3))
    expect = TRig.animate(t_av, poses, trans, device="cpu").numpy()
    p = str(tmp_path / "a.glb")
    TGl.export_avatar_glb(p, t_av, poses=poses, trans=trans,
                          max_influences=24)
    gltf, blob = TGl.read_glb(p)
    for f in range(3):
        np.testing.assert_allclose(_eval_skinned_gltf(gltf, blob, f),
                                   expect[f], atol=2e-5)


def test_weight_truncation_equals_tpubodys():
    w = np.random.default_rng(5).dirichlet(np.ones(24), size=50)
    for k in (4, 8, 24):
        for (ja, wa), (jb, wb) in zip(TGl._skin_sets(w, k),
                                      JGl._skin_sets(w, k)):
            np.testing.assert_array_equal(ja, jb)
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_allclose(wa.sum(axis=1) if k == 4 else 1.0,
                                       1.0, atol=1e-6)


def test_read_glb_rejects_other_files(tmp_path):
    p = tmp_path / "x.glb"
    p.write_bytes(b"not a glb file at all")
    with pytest.raises(ValueError, match="glTF"):
        TGl.read_glb(str(p))
