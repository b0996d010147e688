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
from tpubody_torch.core.rotations import rodrigues
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
        a = fused_lbs.fused_lbs(lay, feat, g, None, prec)
        b = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g, None,
                                           prec)
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="precision"):
        fused_lbs.fused_lbs(lay, feat, g, None, "high")


# -- the model's split planes, read back by the mma.sync m16n8k16 fragment
# definitions of the PTX ISA (lane = 4 * groupID + threadID_in_group; a
# 32-bit register holds two bf16 values, the lower one first); the kernel's
# entry point splits the per-frame rows as split_planes does, on the card
# (split_frames_kernel)

def decode_b(planes):
    """(3, N/16, items, 32, 8) B-fragment words -> (3, 16 * items, N):
    register r of column tile n8 holds rows k = 2t + (0, 1) (+ 8 for the
    second register), column groupID."""
    p = planes.float().numpy()
    P, NT, items = p.shape[:3]
    out = np.full((P, items, 16, NT, 16), np.nan, np.float32)
    for lane in range(32):
        grp, t = divmod(lane, 4)
        for j in range(8):
            reg, half = divmod(j, 2)
            ntile, second = divmod(reg, 2)
            k = 2 * t + half + 8 * second
            out[:, :, k, :, ntile * 8 + grp] = p[:, :, :, lane, j].transpose(
                0, 2, 1)
    return out.reshape(P, items * 16, NT * 16)


def padded_operands(lay, feat, g):
    """The fp32 matrices of the products: B (16 * (3 KS + JS), Vp), which
    the model's planes must hold, and A (Fp, 16 * (KS + 12 JS)), which the
    kernel splits as its fragments load; zero padded."""
    K, V = lay.basis.shape[1:]
    J, F = lay.wT.shape[0], feat.shape[0]
    KS, JS = (K + 15) // 16, (J + 15) // 16
    Vp, Fp = -(-V // 64) * 64, -(-F // 64) * 64
    B = np.zeros((16 * (3 * KS + JS), Vp), np.float32)
    for c in range(3):
        B[16 * KS * c:16 * KS * c + K, :V] = lay.basis[c].numpy()
    B[48 * KS:48 * KS + J, :V] = lay.wT.numpy()
    A = np.zeros((Fp, 16 * (KS + 12 * JS)), np.float32)
    A[:F, :K] = feat.numpy()
    gT = g.numpy().transpose(0, 2, 1)
    for e in range(12):
        A[:F, 16 * KS + 16 * JS * e:16 * KS + 16 * JS * e + J] = gT[:, e]
    return A, B, KS, JS


@pytest.mark.parametrize("frames_n", [6, 5])
def test_split_planes_sum_back_and_pad_with_zeros(data, frames_n):
    """hi + lo is the bf16x3 split (residual <= 2^-16 |x|), hi + lo + lo2
    the three-way one (<= 2^-24 |x|); every pad row and column is zero in
    every plane; nothing of the planes is left unwritten."""
    d = data
    lay = fused_lbs.model_layouts(d["model"])
    feat, g = fused_lbs.lbs_prologue(
        lay, d["model"].parents, torch.as_tensor(d["poses"][:frames_n]),
        torch.as_tensor(d["betas_f"][:frames_n]))
    A, B, KS, JS = padded_operands(lay, feat, g)
    A_planes = fused_lbs.split_planes(torch.from_numpy(A)).float().numpy()
    for want, got in ((B, decode_b(lay.planes)), (A, A_planes)):
        assert got.shape[1:] == want.shape and not np.isnan(got).any()
        two = got[0].astype(np.float64) + got[1]
        three = two + got[2]
        assert (np.abs(two - want) <= 2.0 ** -16 * np.abs(want)).all()
        assert (np.abs(three - want) <= 2.0 ** -24 * np.abs(want)).all()
        assert not got[:, want == 0].any()       # the pads and the zeros
    # the hi and lo planes are _split_bf16's parts bit for bit
    hi, lo = fused_lbs._split_bf16(lay.basis)
    got = decode_b(lay.planes)
    V = lay.basis.shape[2]
    np.testing.assert_array_equal(got[0, :lay.basis.shape[1], :V],
                                  hi[0].numpy())
    np.testing.assert_array_equal(got[1, :lay.basis.shape[1], :V],
                                  lo[0].numpy())
    hi, lo = fused_lbs._split_bf16(torch.from_numpy(A))
    np.testing.assert_array_equal(A_planes[0], hi.numpy())
    np.testing.assert_array_equal(A_planes[1], lo.numpy())


@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_products_of_the_planes_match_plain(data, precision):
    """The kernel's arithmetic from its planes, in the kernel's order: per
    coordinate and transform entry, the products hi*hi + hi*lo + lo*hi
    (bf16x3) or with hi*lo2 + lo2*hi + lo*lo ("highest"), then the apply
    step; held to the plain version at the tolerances above."""
    d = data
    lay = fused_lbs.model_layouts(d["model"])
    F = 5
    feat, g = fused_lbs.lbs_prologue(
        lay, d["model"].parents, torch.as_tensor(d["poses"][:F]),
        torch.as_tensor(d["betas_f"][:F]))
    A, _, KS, JS = padded_operands(lay, feat, g)
    A = fused_lbs.split_planes(torch.from_numpy(A)).float()
    B = torch.from_numpy(decode_b(lay.planes))
    pairs = [(1, 0), (0, 1), (0, 0)]
    if precision == "highest":
        pairs = [(2, 0), (0, 2), (1, 1)] + pairs

    def dot(a_cols, b_rows):
        return sum(A[p][:, a_cols] @ B[q][b_rows] for p, q in pairs)

    V = lay.basis.shape[2]
    v = [dot(slice(0, 16 * KS), slice(16 * KS * c, 16 * KS * (c + 1)))
         for c in range(3)]
    wrows = slice(48 * KS, 48 * KS + 16 * JS)
    out = torch.zeros((A.shape[1], B.shape[2], 3))
    trans = torch.as_tensor(d["trans"][:F])
    for r in range(3):
        for e in range(4):
            c0 = 16 * KS + 16 * JS * (r * 4 + e)
            T = dot(slice(c0, c0 + 16 * JS), wrows)
            out[..., r] += T * v[e] if e < 3 else T
    got = out[:F, :V] + trans[:, None, :]
    want = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g, trans,
                                         precision)
    _close(got.numpy(), want.numpy(), precision)


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
    """F = 6 and 5 (ragged in the 16-frame row tiles), 70 (past one 64-frame
    block tile); V = 700 (ragged in the 64-vertex tiles)."""
    from tpubody_torch import native

    d = data
    m = d["model"].to(cuda)
    lay = fused_lbs.model_layouts(m)
    rng = np.random.default_rng(5)
    poses70 = rng.normal(scale=0.3, size=(70, 24, 3)).astype(np.float32)
    for poses, beta in ((d["poses"], d["beta"]), (d["poses"][:5],
                        d["betas_f"][:5]), (poses70, d["beta"])):
        F = poses.shape[0]
        feat, g = fused_lbs.lbs_prologue(
            lay, m.parents, torch.as_tensor(poses, device=cuda),
            torch.as_tensor(beta, device=cuda))
        trans = torch.as_tensor(rng.normal(size=(F, 3)).astype(np.float32),
                                device=cuda)
        before = native.LAUNCHES["fused_lbs"]
        got = fused_lbs.fused_lbs(lay, feat, g, trans, precision)
        torch.cuda.synchronize()
        assert native.LAUNCHES["fused_lbs"] == before + 1
        want = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g,
                                             trans, precision)
        _close(got.cpu().numpy(), want.cpu().numpy(), precision)
    with pytest.raises(ValueError, match="dtype"):
        fused_lbs.fused_lbs(lay._replace(planes=lay.planes.float()), feat,
                            g, None, precision)


# -- SMPL-X: betas ⊕ expression on shapedirs ⊕ expr_dirs ---------------------
def smplx_lbs_numpy(raw, rotmats, coeffs, trans):
    """Plain float64 SMPL-X LBS: rest joints from the template shaped by
    betas and expression, forward kinematics, the blended transforms."""
    basis = np.concatenate([raw["shapedirs"], raw["expr_dirs"]], axis=-1)
    parents = raw["parents"]
    out = []
    for R, c, t in zip(rotmats.astype(np.float64), coeffs, trans):
        v = raw["v_template"] + basis @ c
        j = raw["j_regressor"] @ v
        v = v + raw["posedirs"] @ (R[1:] - np.eye(3)).reshape(-1)
        G = np.zeros((len(parents), 4, 4))
        for i, p in enumerate(parents):
            local = np.eye(4)
            local[:3, :3] = R[i]
            local[:3, 3] = j[i] - (j[p] if p >= 0 else 0)
            G[i] = local if p < 0 else G[p] @ local
        G[:, :3, 3] -= np.einsum("jab,jb->ja", G[:, :3, :3], j)
        T = np.einsum("vj,jab->vab", raw["weights"], G)
        out.append(np.einsum("vab,vb->va", T[:, :3, :3], v)
                   + T[:, :3, 3] + t)
    return np.stack(out)


@pytest.fixture(scope="module")
def smplx_data():
    rng = np.random.default_rng(11)
    F = 6
    raw = tparams.synthetic_numpy(n_joints=55, n_verts=500, seed=3)
    poses = rng.normal(scale=0.3, size=(F, 55, 3)).astype(np.float32)
    return dict(
        raw=raw, model=tparams.params_from_numpy(raw),
        rotmats=rodrigues(torch.as_tensor(poses)),
        coeffs=rng.normal(size=(F, 20)).astype(np.float32),
        trans=rng.normal(size=(F, 3)).astype(np.float32))


@pytest.mark.parametrize("path", ("forward_batch_verts", "kernel layouts"))
def test_smplx_expression_matches_plain_lbs(smplx_data, path):
    """Betas ⊕ expression (20 a frame) through both CPU paths against the
    plain float64 SMPL-X LBS: the torch-op LBS at the "highest" bar, the
    fused LBS's plain version in bf16x3 at its relative bar.  The
    expression moves the vertices."""
    d = smplx_data
    m = d["model"]
    coeffs = torch.as_tensor(d["coeffs"])
    trans = torch.as_tensor(d["trans"])
    want = smplx_lbs_numpy(d["raw"], d["rotmats"].numpy(), d["coeffs"],
                           d["trans"])
    if path == "forward_batch_verts":
        got = tsmpl.forward_batch_verts(m, d["rotmats"], coeffs, trans,
                                        pose_is_rotmat=True)
        _close(got.numpy(), want, "highest")
    else:
        lay = fused_lbs.model_layouts(m, 20)
        assert lay.basis.shape[1] == 9 * 54 + 20 + 1 == 507
        assert fused_lbs.model_layouts(m, 20) is lay
        assert fused_lbs.model_layouts(m) is not lay
        got = fused_lbs.lbs_forward_batch_fused(
            m.v_template, m.shape_basis(20), m.posedirs, m.j_regressor,
            m.weights, m.parents, d["rotmats"], coeffs, trans,
            pose_is_rotmat=True, kernel_precision="bf16x3", layouts=lay)
        _close(got.numpy(), want, "bf16x3")
    betas_only = tsmpl.forward_batch_verts(m, d["rotmats"], coeffs[:, :10],
                                           trans, pose_is_rotmat=True)
    assert np.abs(betas_only.numpy() - want).max() > 1e-3


def test_shape_basis_widths(smplx_data):
    m = smplx_data["model"]
    assert m.shape_basis() is m.shapedirs
    assert m.shape_basis(14).shape == (500, 3, 14)
    assert torch.equal(m.shape_basis(20)[..., 10:], m.expr_dirs)
    with pytest.raises(ValueError, match="expression"):
        m.shape_basis(21)


def test_posed_joint_is_the_forward_pass_joint(smplx_data):
    """The joint read off the prologue's transforms is the torch-op
    forward's posed joint, and ``forward_batch_placed`` puts it at the
    point it is given."""
    d = smplx_data
    m = d["model"]
    coeffs = torch.as_tensor(d["coeffs"])
    state = tsmpl.forward(m, d["rotmats"], coeffs, pose_is_rotmat=True)
    layouts = fused_lbs.model_layouts(m, 20)
    _, g = fused_lbs.lbs_prologue(layouts, m.parents, d["rotmats"], coeffs,
                                  pose_is_rotmat=True)
    point = torch.as_tensor(d["trans"])
    for joint in (15, 0, 54):
        got = fused_lbs.posed_joint(layouts, g, coeffs, joint)
        torch.testing.assert_close(got, state.joints_posed[:, joint],
                                   rtol=0, atol=1e-5)
        verts, transl = tsmpl.forward_batch_placed(m, d["rotmats"], coeffs,
                                                   joint, point)
        torch.testing.assert_close(transl, point - got, rtol=0, atol=1e-5)
        torch.testing.assert_close(verts, state.verts + transl[:, None],
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", fused_lbs.PRECISIONS)
def test_cuda_kernel_smplx_shape(cuda, precision):
    """SMPL-X on the served path: F = 512 bodies, V = 10,475, K = 486 + 20
    + 1 = 507, J = 55, with a translation, against the plain version on
    the card at the bars of the J = 24 test."""
    from tpubody_torch import native

    m = tparams.synthetic(n_joints=55, n_verts=10475, seed=4).to(cuda)
    lay = fused_lbs.model_layouts(m, 20)
    rng = np.random.default_rng(6)
    F = 512
    poses = torch.as_tensor(rng.normal(scale=0.3, size=(F, 55, 3)),
                            dtype=torch.float32, device=cuda)
    coeffs = torch.as_tensor(rng.normal(size=(F, 20)), dtype=torch.float32,
                             device=cuda)
    trans = torch.as_tensor(rng.normal(size=(F, 3)), dtype=torch.float32,
                            device=cuda)
    feat, g = fused_lbs.lbs_prologue(lay, m.parents, poses, coeffs)
    assert feat.shape == (F, 507) and g.shape == (F, 55, 12)
    before = native.LAUNCHES["fused_lbs"]
    got = fused_lbs.fused_lbs(lay, feat, g, trans, precision)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_lbs"] == before + 1
    want = fused_lbs.fused_lbs_reference(lay.basis, lay.wT, feat, g, trans,
                                         precision)
    assert got.shape == (F, 10475, 3)
    _close(got.cpu().numpy(), want.cpu().numpy(), precision)
