"""The fused LBS of tpubody_torch.core.fused_lbs against tpubody's Pallas
kernel (core/pallas_lbs.py) run in interpret mode on the CPU, as
tests/test_pallas_lbs.py runs it (frame_tile=4, vert_tile=256).

Tolerances are those of tests/test_pallas_lbs.py: max |d| < 2e-5 for
"highest" (fp32 contractions in another summation order) and relative
error < 1e-4 for "bf16x3" (both sides emulate the same hi/lo split; the
sums differ in order).  The CUDA kernel itself runs only on a GPU: its
test skips here and runs on the card with
``python -m pytest --noconftest -p no:cacheprovider -k cuda tests/test_torch_fused_lbs.py``
(without the root conftest, which forces JAX onto the CPU, the JAX-side
tests are not meant to run there).
"""
import numpy as np
import pytest
import torch

from tpubody_torch.core import fused_lbs
from tpubody_torch.models import params as tparams
from tpubody_torch.models import smpl as tsmpl

torch.set_num_threads(1)

HIGHEST_ATOL = 2e-5
BF16X3_REL = 1e-4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    F = 6
    return dict(
        poses=rng.normal(scale=0.3, size=(F, 24, 3)).astype(np.float32),
        beta=rng.normal(size=(10,)).astype(np.float32),
        betas_f=rng.normal(scale=0.5, size=(F, 10)).astype(np.float32),
        trans=rng.normal(size=(F, 3)).astype(np.float32),
        model=tparams.synthetic(n_joints=24, n_verts=700, seed=2,
                                device="cpu"),
    )


@pytest.fixture(scope="module")
def jax_ref():
    """tpubody's Pallas kernel in interpret mode, and its XLA LBS path."""
    pallas_lbs = pytest.importorskip("tpubody.core.pallas_lbs")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tpubody.core.rotations import rodrigues
    from tpubody.models import params as jparams
    from tpubody.models import smpl as jsmpl

    model = jparams.synthetic(n_joints=24, n_verts=700, seed=2)

    def fused(poses, beta, trans, precision, rotmat=False):
        with pltpu.force_tpu_interpret_mode():
            out = pallas_lbs.lbs_forward_batch_fused(
                model.v_template, model.shapedirs, model.posedirs,
                model.j_regressor, model.weights, model.parents,
                jnp.asarray(poses), jnp.asarray(beta),
                None if trans is None else jnp.asarray(trans),
                frame_tile=4, vert_tile=256, pose_is_rotmat=rotmat,
                kernel_precision=precision)
        return np.asarray(out)

    def xla(poses, beta, trans):
        return np.asarray(jsmpl.forward_batch(
            model, jnp.asarray(poses), jnp.asarray(beta),
            jnp.asarray(trans)).verts)

    def rotmats(poses):
        return np.asarray(rodrigues(jnp.asarray(poses)))

    return dict(fused=fused, xla=xla, rotmats=rotmats)


def _port(model, poses, beta, trans, precision, rotmat=False):
    return fused_lbs.lbs_forward_batch_fused(
        model.v_template, model.shapedirs, model.posedirs,
        model.j_regressor, model.weights, model.parents,
        torch.tensor(poses), torch.tensor(beta),
        None if trans is None else torch.tensor(trans),
        pose_is_rotmat=rotmat, kernel_precision=precision,
        layouts=fused_lbs.model_layouts(model)).numpy()


def _close(got, want, precision):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    if precision == "highest":
        assert err < HIGHEST_ATOL, err
    else:
        assert err / np.abs(want).max() < BF16X3_REL, err


@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_plain_matches_pallas_interpret(data, jax_ref, precision):
    d = data
    want = jax_ref["fused"](d["poses"], d["beta"], d["trans"], precision)
    got = _port(d["model"], d["poses"], d["beta"], d["trans"], precision)
    _close(got, want, precision)


@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_plain_handles_ragged_frames(data, jax_ref, precision):
    """F = 5 and V = 700: not multiples of any tile."""
    d = data
    want = jax_ref["fused"](d["poses"][:5], d["beta"], d["trans"][:5],
                            precision)
    got = _port(d["model"], d["poses"][:5], d["beta"], d["trans"][:5],
                precision)
    assert got.shape == (5, 700, 3)
    _close(got, want, precision)


@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_plain_per_frame_betas(data, jax_ref, precision):
    d = data
    want = jax_ref["fused"](d["poses"], d["betas_f"], d["trans"], precision)
    got = _port(d["model"], d["poses"], d["betas_f"], d["trans"], precision)
    _close(got, want, precision)


@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_plain_rotmat_input_no_trans(data, jax_ref, precision):
    d = data
    R = jax_ref["rotmats"](d["poses"])
    want = jax_ref["fused"](R, d["betas_f"], None, precision, rotmat=True)
    got = _port(d["model"], R, d["betas_f"], None, precision, rotmat=True)
    _close(got, want, precision)


def test_plain_matches_xla_lbs(data, jax_ref):
    d = data
    want = jax_ref["xla"](d["poses"], d["beta"], d["trans"])
    got = _port(d["model"], d["poses"], d["beta"], d["trans"], "highest")
    _close(got, want, "highest")


def test_wrapper_uses_plain_version_on_cpu(data):
    d = data
    m = d["model"]
    lay = fused_lbs.model_layouts(m)
    feat, g = fused_lbs.lbs_prologue(lay, m.parents,
                                     torch.as_tensor(d["poses"]),
                                     torch.as_tensor(d["beta"]))
    assert feat.shape == (6, 9 * 23 + 10 + 1) and g.shape == (6, 24, 12)
    for prec in fused_lbs.PRECISIONS:
        a = fused_lbs.fused_lbs(lay.basis, lay.wT, feat, g, None, prec)
        b = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g, None,
                                           prec)
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="precision"):
        fused_lbs.fused_lbs(lay.basis, lay.wT, feat, g, None, "high")


def test_layouts_cached_on_model(data):
    m = tparams.synthetic(n_joints=24, n_verts=50, seed=0, device="cpu")
    lay = fused_lbs.model_layouts(m)
    assert fused_lbs.model_layouts(m) is lay
    K = 9 * 23 + 10 + 1
    assert lay.basis.shape == (3, K, 50) and lay.basis.is_contiguous()
    assert lay.wT.shape == (24, 50) and lay.wT.is_contiguous()
    torch.testing.assert_close(lay.basis[:, -1, :], m.v_template.t())


def test_use_kernel_true_on_cpu_raises(data):
    d = data
    with pytest.raises(ValueError, match="CUDA"):
        tsmpl.forward_batch_verts(d["model"], torch.as_tensor(d["poses"]),
                                  torch.as_tensor(d["beta"]),
                                  use_kernel=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused_lbs kernel has no CPU "
                    "mode; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_cuda_kernel_matches_plain(data, cuda, precision):
    from tpubody_torch import native

    d = data
    m = d["model"].to(cuda)
    lay = fused_lbs.model_layouts(m)
    for F, beta in ((6, d["beta"]), (5, d["betas_f"][:5])):
        feat, g = fused_lbs.lbs_prologue(
            lay, m.parents, torch.as_tensor(d["poses"][:F], device=cuda),
            torch.as_tensor(beta, device=cuda))
        trans = torch.as_tensor(d["trans"][:F], device=cuda)
        before = native.LAUNCHES["fused_lbs"]
        got = fused_lbs.fused_lbs(lay.basis, lay.wT, feat, g, trans,
                                  precision)
        torch.cuda.synchronize()
        assert native.LAUNCHES["fused_lbs"] == before + 1
        want = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g,
                                             trans, precision)
        _close(got.cpu().numpy(), want.cpu().numpy(), precision)
    with pytest.raises(ValueError, match="dtype"):
        fused_lbs.fused_lbs(lay.basis.double(), lay.wT, feat, g, None,
                            precision)
