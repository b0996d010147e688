"""tpubody_torch.models.params / humanoid against tpubody's: the same seed
gives bit-identical float64 arrays, and a tpubody ``save_npz`` file loads
into the port."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.models import humanoid as jhum
from tpubody.models import params as jparams
from tpubody_torch.models import humanoid as thum
from tpubody_torch.models import params as tparams

torch.set_num_threads(1)

KEYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights",
        "faces")


def _assert_identical(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if k == "parents":
            assert tuple(a[k]) == tuple(b[k])
            continue
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("n_joints,n_verts,seed",
                         [(24, 300, 0), (52, 400, 3), (55, 500, 1)])
def test_synthetic_numpy_bit_identical(n_joints, n_verts, seed):
    _assert_identical(jparams.synthetic_numpy(n_joints, n_verts, 10, seed),
                      tparams.synthetic_numpy(n_joints, n_verts, 10, seed))


@pytest.mark.parametrize("n_joints,n_verts,seed",
                         [(24, 6890, 0), (52, 2000, 2), (55, 3000, 0)])
def test_humanoid_numpy_bit_identical(n_joints, n_verts, seed):
    _assert_identical(jhum.humanoid_numpy(n_joints, n_verts, 10, seed),
                      thum.humanoid_numpy(n_joints, n_verts, 10, seed))


def test_synthetic_tensors_match():
    j = jparams.synthetic(n_joints=24, n_verts=300, seed=4)
    t = tparams.synthetic(n_joints=24, n_verts=300, seed=4, device="cpu")
    for k in KEYS[:-1]:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
        assert getattr(t, k).dtype == torch.float32
    assert t.parents == j.parents
    assert (t.num_joints, t.num_verts, t.num_betas) == (24, 300, 10)


def test_load_or_synthetic_is_humanoid_at_full_size():
    t = tparams.load_or_synthetic("smpl", n_verts=6890, warn=False,
                                  device="cpu")
    j = jparams.load_or_synthetic("smpl", n_verts=6890, warn=False)
    np.testing.assert_array_equal(t.v_template.numpy(),
                                  np.asarray(j.v_template))
    # Too few vertices for the humanoid: the blob stand-in.
    small = tparams.load_or_synthetic("smpl", n_verts=64, warn=False,
                                      device="cpu")
    assert small.num_verts == 64


def test_npz_from_tpubody_loads(tmp_path):
    j = jparams.synthetic(n_joints=55, n_verts=400, seed=5)
    path = str(tmp_path / "model.npz")
    jparams.save_npz(path, j)
    t = tparams.load(path, device="cpu")
    for k in KEYS[:-1] + ("expr_dirs",):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.lmk_faces_idx, j.lmk_faces_idx)
    assert t.parents == j.parents


def _hands(model, as_array):
    """The model with seeded SMPLH hand PCA bases and means (the synthetic
    generators make none)."""
    rng = np.random.default_rng(7)
    arrays = {k: rng.normal(size=shape).astype(np.float32)
              for k, shape in (("hands_components_l", (12, 45)),
                               ("hands_components_r", (12, 45)),
                               ("hands_mean_l", (45,)),
                               ("hands_mean_r", (45,)))}
    return dataclasses.replace(
        model, **{k: as_array(v) for k, v in arrays.items()})


@pytest.mark.parametrize("extras", ["none", "hands_and_landmarks"])
def test_save_npz_both_directions(tmp_path, extras):
    """The port's file and tpubody's hold the same keys and bit-equal
    arrays of the same dtypes; each package reads the other's."""
    n_joints = 24 if extras == "none" else 55       # 55: expr + landmarks
    j = jparams.synthetic(n_joints=n_joints, n_verts=400, seed=5)
    t = tparams.synthetic(n_joints=n_joints, n_verts=400, seed=5,
                          device="cpu")
    if extras != "none":
        j = _hands(j, jnp.asarray)
        t = _hands(t, torch.as_tensor)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jparams.save_npz(jpath, j)
    tparams.save_npz(tpath, t)
    zj, zt = np.load(jpath), np.load(tpath)
    assert set(zt.files) == set(zj.files)
    assert ("hands_mean_l" in zt.files) == ("lmk_faces_idx" in zt.files) \
        == (extras != "none")
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        assert zt[k].dtype == zj[k].dtype, k
    fields = KEYS[:-1] + ("hands_components_l", "hands_components_r",
                          "hands_mean_l", "hands_mean_r", "expr_dirs")
    from_port = jparams.load_npz(tpath)
    from_jax = tparams.load_npz(jpath)
    for k in fields:
        if getattr(j, k) is None:
            assert getattr(from_port, k) is None
            assert getattr(from_jax, k) is None
            continue
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      np.asarray(getattr(j, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(from_jax, k).numpy(),
                                      getattr(t, k).numpy(), err_msg=k)
    for k in ("faces", "lmk_faces_idx", "lmk_bary_coords"):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, k)),
                                      np.asarray(getattr(j, k)), err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(from_jax, k)),
                                      np.asarray(getattr(t, k)), err_msg=k)
    assert from_port.parents == j.parents and from_jax.parents == t.parents


def test_to_and_astype_start_fresh_cache():
    t = tparams.synthetic(n_verts=100, device="cpu")
    t.cache["x"] = 1
    moved = t.to("cpu")
    assert moved.cache == {} and moved.v_template.device.type == "cpu"
    half = t.astype(torch.float64)
    assert half.shapedirs.dtype == torch.float64 and half.cache == {}
    assert t.cache == {"x": 1}


def test_parents_for():
    assert tparams.parents_for(24) == jparams.SMPL_PARENTS
    assert tparams.parents_for(52) == jparams.SMPLH_PARENTS
    assert tparams.parents_for(55) == jparams.SMPLX_PARENTS
    with pytest.raises(ValueError):
        tparams.parents_for(23)
