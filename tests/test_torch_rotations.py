"""tpubody_torch.core.rotations against tpubody.core.rotations on the same
seeded inputs.  Tolerance: atol 1e-6 (both compute in fp32 on the CPU with
the same formulas and epsilon placement)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.core import rotations as jrot
from tpubody_torch.core import rotations as trot

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    aa = rng.normal(scale=1.0, size=(5, 7, 3)).astype(np.float32)
    aa[0, 0] = 0.0                                     # the r == 0 guard
    quat = rng.normal(size=(5, 7, 4)).astype(np.float32)
    six = rng.normal(size=(5, 7, 6)).astype(np.float32)
    R = np.asarray(jrot.rodrigues(jnp.asarray(aa)))
    # Rotations near each branch of the quaternion extraction.
    near_pi = np.asarray(jrot.rodrigues(jnp.asarray(np.array(
        [[3.1, 0.0, 0.0], [0.0, 3.1, 0.0], [0.0, 0.0, 3.1],
         [2.0, 2.0, 0.5]], np.float32))))
    return {"aa": aa, "quat": quat, "six": six, "R": R, "near_pi": near_pi}


CASES = [
    ("rodrigues", "aa"),
    ("quat_to_rotmat", "quat"),
    ("axis_angle_to_quat", "aa"),
    ("rot6d_to_rotmat", "six"),
    ("rotmat_to_rot6d", "R"),
    ("rotmat_to_quat", "R"),
    ("rotmat_to_quat", "near_pi"),
    ("rotmat_to_axis_angle", "R"),
    ("rotmat_to_axis_angle", "near_pi"),
]


@pytest.mark.parametrize("fn,arg", CASES, ids=[f"{f}-{a}" for f, a in CASES])
def test_matches_tpubody(fn, arg):
    x = _inputs()[arg]
    want = np.asarray(getattr(jrot, fn)(jnp.asarray(x)))
    got = getattr(trot, fn)(torch.tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_all_seven_functions_ported():
    names = {"rodrigues", "quat_to_rotmat", "axis_angle_to_quat",
             "rot6d_to_rotmat", "rotmat_to_rot6d", "rotmat_to_quat",
             "rotmat_to_axis_angle"}
    assert names == {f for f, _ in CASES}
    for n in names:
        assert callable(getattr(trot, n))
