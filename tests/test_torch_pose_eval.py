"""tpubody_torch.utils.pose_eval against tpubody.utils.pose_eval on seeded
(B, J, 3) joints, in float32 on the CPU.  Bar: 1e-5 absolute on
unit-scale inputs (two 3x3 SVDs in another LAPACK path agree to a few
float32 ulps; the outputs are O(1))."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.utils import pose_eval as jeval
from tpubody_torch.utils import pose_eval as teval

ATOL = 1e-5


def _rot(rng):
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return Q * np.sign(np.linalg.det(Q))


def _pair(seed, B=4, J=17, reflect=False):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=(B, J, 3))
    pred = np.stack([0.8 * g @ _rot(rng).T + rng.normal(size=3) for g in gt])
    pred += 0.05 * rng.normal(size=pred.shape)
    if reflect:
        pred = pred * np.array([-1.0, 1.0, 1.0])
    return pred.astype(np.float32), gt.astype(np.float32)


def _both(fn_name, *arrays, **kw):
    want = np.asarray(getattr(jeval, fn_name)(
        *[jnp.asarray(a) for a in arrays], **kw))
    got = getattr(teval, fn_name)(*[torch.as_tensor(a) for a in arrays],
                                  **kw).numpy()
    return got, want


@pytest.mark.parametrize("reflect", [False, True])
def test_procrustes_align(reflect):
    """reflect=True: the cross-covariance has det < 0, so the guard flips
    the smallest singular direction (no improper rotation)."""
    pred, gt = _pair(0, reflect=reflect)
    got, want = _both("procrustes_align", pred, gt)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if reflect:
        K = np.einsum("bji,bjk->bik", gt - gt.mean(1, keepdims=True),
                      pred - pred.mean(1, keepdims=True))
        assert (np.linalg.det(K) < 0).all()


@pytest.mark.parametrize("root", [0, 3, None])
def test_mpjpe(root):
    pred, gt = _pair(1)
    got, want = _both("mpjpe", pred, gt, root=root)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("reflect", [False, True])
def test_pa_mpjpe(reflect):
    pred, gt = _pair(2, reflect=reflect)
    got, want = _both("pa_mpjpe", pred, gt)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got <= teval.mpjpe(torch.as_tensor(pred),
                               torch.as_tensor(gt)).numpy() + 1e-6).all()


def test_pve():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 200, 3)).astype(np.float32)
    b = (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32)
    got, want = _both("pve", a, b)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_evaluate_batch():
    pred, gt = _pair(4, B=5, J=24)
    want = jeval.evaluate_batch(jnp.asarray(pred), jnp.asarray(gt))
    got = teval.evaluate_batch(torch.as_tensor(pred), torch.as_tensor(gt))
    assert set(got) == set(want) == {"mpjpe", "pa_mpjpe"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL)


def test_exact_similarity_recovered():
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(1, 12, 3))
    pred = 0.37 * gt @ _rot(rng).T + np.array([1.0, -2.0, 0.5])
    got = teval.procrustes_align(torch.as_tensor(pred),
                                 torch.as_tensor(gt)).numpy()
    np.testing.assert_allclose(got, gt, atol=1e-10)
