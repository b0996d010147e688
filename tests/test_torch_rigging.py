"""tpubody_torch.mesh.rigging and .decimate against tpubody's.

``animate`` is float32 LBS on both sides (max |d| < 1e-5, the sums differ
in order); avatar pickles written by one package are read by the other
(exact); ``decimate_avatar`` is float64 numpy on both sides (exact)."""
import numpy as np
import pytest
import torch

from tpubody.mesh import decimate as jdecimate
from tpubody.mesh import rigging as jrigging
from tpubody.models import params as jparams
from tpubody_torch.mesh import decimate as tdecimate
from tpubody_torch.mesh import rigging as trigging

torch.set_num_threads(1)

ANIMATE_ATOL = 1e-5


def sphere(n_lat=12, n_lon=16, radius=0.3):
    """A small UV sphere (V = n_lat * n_lon + 2)."""
    verts = [[0.0, radius, 0.0]]
    for i in range(1, n_lat + 1):
        th = np.pi * i / (n_lat + 1)
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(th) * np.cos(ph),
                          radius * np.cos(th),
                          radius * np.sin(th) * np.sin(ph)])
    verts.append([0.0, -radius, 0.0])
    faces = []
    for j in range(n_lon):
        faces.append([0, 1 + j, 1 + (j + 1) % n_lon])
    for i in range(n_lat - 1):
        a, b = 1 + i * n_lon, 1 + (i + 1) * n_lon
        for j in range(n_lon):
            k = (j + 1) % n_lon
            faces.append([a + j, b + j, b + k])
            faces.append([a + j, b + k, a + k])
    last = len(verts) - 1
    base = 1 + (n_lat - 1) * n_lon
    for j in range(n_lon):
        faces.append([last, base + (j + 1) % n_lon, base + j])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def sphere_avatar_arrays(seed=2):
    """The arrays of a sphere avatar rigged to a random 24-joint tree (the
    construction of tests/test_animate.py)."""
    verts, faces = sphere()
    rng = np.random.default_rng(seed)
    parents = jparams.SMPL_PARENTS
    joints = np.zeros((24, 3))
    for i in range(1, 24):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        joints[i] = joints[parents[i]] + d * 0.08
    dist = np.linalg.norm(verts[:, None] - joints[None], axis=-1)
    w = np.exp(-dist / 0.05)
    w /= w.sum(1, keepdims=True)
    return dict(v_template=verts, weights=w,
                color=rng.uniform(0.2, 0.9, size=verts.shape), faces=faces,
                joints=joints, parents=tuple(parents))


def both_avatars(seed=2):
    a = sphere_avatar_arrays(seed)
    jav = jrigging.RiggedAvatar(or_pose=np.zeros((24, 3)),
                                or_shape=np.zeros(10), **a)
    return jav, trigging.avatar_from_numpy(**a)


def test_avatar_fields_match():
    jav, tav = both_avatars()
    assert jav._fields == tav._fields
    assert trigging.IGNORED_JOINTS == jrigging.IGNORED_JOINTS
    for name in jav._fields:
        if name == "parents":
            assert tuple(jav.parents) == tav.parents
        else:
            np.testing.assert_array_equal(getattr(jav, name),
                                          getattr(tav, name))


@pytest.mark.parametrize("with_trans", [False, True])
def test_animate_matches(with_trans):
    jav, tav = both_avatars()
    rng = np.random.default_rng(0)
    poses = rng.normal(scale=0.3, size=(5, 24, 3))
    trans = rng.normal(size=(5, 3)) if with_trans else None
    want = np.asarray(jrigging.animate(jav, poses, trans))
    got = trigging.animate(tav, poses, trans, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() < ANIMATE_ATOL
    # the ignored joints really are pose-zeroed
    p2 = poses.copy()
    p2[:, list(trigging.IGNORED_JOINTS)] = 0.0
    again = trigging.animate(tav, p2, trans, device="cpu")
    assert torch.equal(got, again)


def test_animate_defaults_to_the_card():
    _, tav = both_avatars()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            trigging.animate(tav, np.zeros((1, 24, 3)))


@pytest.mark.parametrize("writer,reader", [(trigging, jrigging),
                                           (jrigging, trigging)])
def test_avatar_pickle_across_packages(tmp_path, writer, reader):
    jav, tav = both_avatars(seed=3)
    src = tav if writer is trigging else jav
    p = str(tmp_path / "avatar.pkl")
    writer.save_avatar(p, src)
    back = reader.load_avatar(p)
    for name in ("v_template", "weights", "color", "faces", "joints",
                 "or_pose"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(src, name))
    assert tuple(back.parents) == tuple(src.parents)
    assert back.faces.dtype == np.int64


def test_pickle_bytes_equal(tmp_path):
    """Both packages write the same schema with the same values."""
    import pickle

    jav, tav = both_avatars()
    pj, pt = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jrigging.save_avatar(pj, jav)
    trigging.save_avatar(pt, tav)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        dj, dt = pickle.load(f), pickle.load(g)
    assert dj.keys() == dt.keys()
    for k in dj:
        if k == "parent":
            assert dj[k] == dt[k]
        else:
            np.testing.assert_array_equal(dj[k], dt[k])


@pytest.mark.parametrize("target", [60, 120])
def test_decimate_avatar_equal(target):
    jav, tav = both_avatars()
    want = jdecimate.decimate_avatar(jav, target_verts=target)
    got = tdecimate.decimate_avatar(tav, target_verts=target)
    assert isinstance(got, trigging.RiggedAvatar)
    assert got.v_template.shape[0] < tav.v_template.shape[0]
    for name in ("v_template", "weights", "color", "faces", "joints"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


def test_cluster_decimate_equal():
    verts, faces = sphere()
    pts = np.concatenate([verts, np.random.default_rng(1).uniform(
        size=(verts.shape[0], 4))], axis=1)
    want = jdecimate.cluster_decimate(pts, faces, cell_size=0.08)
    got = tdecimate.cluster_decimate(pts, faces, cell_size=0.08)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdecimate.cluster_decimate(pts, faces)
