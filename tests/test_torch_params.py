"""tpubody_torch.models.params / humanoid against tpubody's: the same seed
gives bit-identical float64 arrays, and a tpubody ``save_npz`` file loads
into the port."""
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
