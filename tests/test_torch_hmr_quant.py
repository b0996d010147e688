"""tpubody_torch.models.hmr_quant against tpubody.models.hmr_quant, and the
int8 serving step against tpubody's.

The pair: tpubody's HMR at 32^2 (full ResNet-50 depth: STAGE_SIZES is
fixed), variables by shape_init with every batch statistic drawn uniform
in [0.5, 1.5] (tests/test_hmr_quant.py's construction, so the fold is
not trivial), loaded into the port's HMR; two images.  tpubody's
reference runs once, in a module fixture.

Bars, each with its reason:
  * the fold: within 1 ulp of tpubody's (both float32 in the same order;
    the port's square root is the correctly rounded one, as XLA's);
  * quantize on tpubody's folded weights: codes and scales bit-equal;
  * calibrate on tpubody's folded weights: scales within rtol 1e-5 (the
    float32 convolutions sum in another order);
  * forward_folded: within 2e-4 of tpubody's (its own bar against the
    Flax model);
  * forward on tpubody's int8 parameters: at least 99.9% of the int8
    codes equal at every conv input (the products are exact integers on
    both sides and the epilogue is the same float32 arithmetic; only a
    rounding tie moved by another summation order could flip one), and
    the outputs within 1e-4 (pool and head sum in another order);
  * the int8 outputs against forward_folded: tpubody's fidelity bar,
    err/scale < 0.15 on pose6d, rotations orthonormal within 1e-4;
  * requantize (the plain version the CPU runs) against the eager chain
    it replaces, _qconv's epilogue then _quantize_input: bit-equal, and
    so is the restructured backbone against the chain of _qconv (the
    same float32 operations in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpubody.models import hmr as jhmr
from tpubody.models import hmr_quant as jq
from tests.torch_requant_common import (TIE_SCALE, dn_scales_apart,
                                        eager_backbone, requant_case)
from tpubody_torch import native
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_quant as tq

torch.set_num_threads(1)

SIZE = 32
CODE_SHARE = 0.999
OUT_ATOL = 1e-4
FOLDED_ATOL = 2e-4
OUTPUTS = ("pose6d", "shape", "cam", "rotmats")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    _, variables = jhmr.create_hmr(dtype=jnp.float32, image_size=SIZE,
                                   init="shape")
    rng = np.random.default_rng(0)
    bs = jax.tree_util.tree_map(
        lambda x: np.asarray(rng.uniform(0.5, 1.5, x.shape), np.float32),
        variables["batch_stats"])
    variables = {**_np_tree(variables), "batch_stats": bs}
    images = rng.normal(scale=0.5, size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    port = thmr.HMR(jhmr.default_mean_params())
    port.load_state_dict(thmr.from_flax_variables(variables))
    port = thmr.to_compute(port, torch.float32, torch.device("cpu"))

    folded = jq.fold_batchnorm(variables)
    scales = jq.calibrate(folded, jnp.asarray(images))
    qparams = jq.quantize(folded, scales)
    codes = []
    apply = jq._qconv_apply

    def recording(qc, x):   # tpubody's own rounding of each conv input
        codes.append(np.asarray(jnp.clip(jnp.round(x / qc.x_scale),
                                         -127.0, 127.0)).astype(np.int8))
        return apply(qc, x)

    jq._qconv_apply = recording
    try:
        out = jq.forward(qparams, jnp.asarray(images))
    finally:
        jq._qconv_apply = apply
    return dict(port=port, images=images, folded=_np_tree(folded),
                scales=scales, qparams=_np_tree(qparams), codes=codes,
                out=_np_tree(out),
                folded_out=_np_tree(jq.forward_folded(folded,
                                                      jnp.asarray(images))))


def _convs(tree):
    yield "stem", tree["stem"]
    for i, stage in enumerate(tree["blocks"]):
        for j, blk in enumerate(stage):
            for k, v in blk.items():
                yield f"l{i}_{j}.{k}", v


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64)).max()


def test_fold_matches_tpubody_within_one_ulp(pair):
    mine = tq.fold_batchnorm(pair["port"])
    theirs = list(_convs(pair["folded"]))
    ours = list(_convs(mine))
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert len(ours) == 53
    for (name, t), (_, j) in zip(ours, theirs):
        assert t.strides == tuple(j.strides) and t.padding == tuple(
            tuple(p) for p in j.padding), name
        assert t.w.shape == j.w.shape, name
        assert _ulps(t.w.numpy(), j.w) <= 1, name
        assert _ulps(t.b.numpy(), j.b) <= 1, name
    for k in tq.HEADS:
        np.testing.assert_array_equal(mine["head"][k]["weight"].numpy(),
                                      pair["folded"]["head"][k]["kernel"].T)


def test_stage_sizes():
    assert tq.STAGE_SIZES == thmr.STAGE_SIZES == jq.STAGE_SIZES
    assert thmr.create_hmr(device="cpu").backbone.stage_sizes == \
        jq.STAGE_SIZES


def test_fold_algebra():
    """conv(x) * g + (beta - mean * g) == BN(conv(x)) (tpubody's check)."""
    rng = np.random.default_rng(1)
    k = torch.as_tensor(rng.normal(size=(3, 3, 4, 8)), dtype=torch.float32)
    scale, var = (torch.as_tensor(rng.uniform(0.5, 2, 8), dtype=torch.float32)
                  for _ in range(2))
    bias, mean = (torch.as_tensor(rng.normal(size=8), dtype=torch.float32)
                  for _ in range(2))
    x = torch.as_tensor(rng.normal(size=(1, 6, 6, 4)), dtype=torch.float32)
    pad = ((1, 1), (1, 1))
    raw = tq._conv_f32(tq.FoldedConv(k, torch.zeros(8), (1, 1), pad), x)
    bn_out = (raw - mean) / torch.sqrt(var + 1e-5) * scale + bias
    wf, bf = tq._fold(k, scale, bias, mean, var)
    folded_out = tq._conv_f32(tq.FoldedConv(wf, bf, (1, 1), pad), x)
    torch.testing.assert_close(folded_out, bn_out, atol=1e-5, rtol=0)


def test_quantize_bit_equal_on_tpubody_folded(pair):
    carried = tq.from_tpubody(pair["folded"])
    mine = tq.quantize(carried, pair["scales"])
    for (name, t), (_, j) in zip(_convs(mine), _convs(pair["qparams"])):
        assert t.w.dtype == torch.int8 and t.w.shape[1] % 8 == 0, name
        np.testing.assert_array_equal(t.hwio().numpy(), j.w, err_msg=name)
        np.testing.assert_array_equal(t.w_scale.numpy(), j.w_scale,
                                      err_msg=name)
        assert t.x_scale.numpy() == np.float32(j.x_scale), name
        np.testing.assert_array_equal(t.b.numpy(), j.b, err_msg=name)
    assert mine["stem"].w.shape == (64, 152)      # K = 147 padded to 152


def test_calibrate_matches_tpubody(pair):
    mine = tq.calibrate(tq.from_tpubody(pair["folded"]), pair["images"])
    assert list(mine) == list(pair["scales"])
    for name, s in pair["scales"].items():
        assert abs(mine[name] - s) <= 1e-5 * s, name


def test_quantized_conv_roundtrip_exact_for_representable():
    """Inputs and weights on the quantization grid pass through the int8
    conv exactly: acc = 3 * (2 + 3) = 15; 15 * 0.25 * 0.5 + 1 = 2.875."""
    w, kernel = tq._pack(torch.tensor([2, 3], dtype=torch.int8)
                         .reshape(1, 1, 2, 1))
    qc = tq.QConv(w=w, w_scale=torch.tensor([0.5]), b=torch.tensor([1.0]),
                  x_scale=torch.tensor(0.25), kernel=kernel, strides=(1, 1),
                  padding=((0, 0), (0, 0)))
    x = torch.full((1, 2, 2, 2), 0.75)
    out = tq._qconv(qc, x, False, "t", None)
    assert out.shape == (1, 2, 2, 1)
    assert torch.all(out == 2.875)


def test_int8_products_are_exact():
    """The CPU route's float64 products equal integer sums at the widest
    K (4608 = 9 * 512) with every code at +-127."""
    rng = np.random.default_rng(3)
    a = rng.choice([-127, 127], size=(5, 4608)).astype(np.int8)
    b = rng.choice([-127, 127], size=(16, 4608)).astype(np.int8)
    got = tq._mm_int8(torch.as_tensor(a), torch.as_tensor(b))
    want = a.astype(np.int64) @ b.astype(np.int64).T
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_folded_matches_tpubody_and_the_model(pair):
    got = tq.forward_folded(tq.fold_batchnorm(pair["port"]), pair["images"])
    with torch.no_grad():
        model = pair["port"](torch.as_tensor(pair["images"]))
    for name in ("pose6d", "shape", "cam"):
        g = getattr(got, name).numpy()
        assert np.abs(g - getattr(pair["folded_out"], name)).max() \
            < FOLDED_ATOL, name
        assert np.abs(g - getattr(model, name).numpy()).max() \
            < FOLDED_ATOL, name


def test_forward_matches_tpubody_on_carried_qparams(pair):
    qp = tq.from_tpubody(pair["qparams"])
    codes = []
    x = torch.as_tensor(pair["images"])
    xf = tq._backbone_int8(qp, x, observe=lambda n, c: codes.append(c))
    got = tq._ief_head(qp["head"], xf, jhmr.default_mean_params())
    assert len(codes) == len(pair["codes"]) == 53
    shares = [float((c.numpy() == j).mean())
              for c, j in zip(codes, pair["codes"])]
    assert min(shares) >= CODE_SHARE, shares
    again = tq.forward(qp, pair["images"])
    for name in OUTPUTS:
        g = getattr(got, name).numpy()
        assert np.abs(g - getattr(pair["out"], name)).max() < OUT_ATOL, name
        np.testing.assert_array_equal(getattr(again, name).numpy(), g)


def test_int8_forward_tracks_f32(pair):
    """tpubody's fidelity bar, on the port's own PTQ of the pair."""
    qp = tq.quantize_hmr(pair["port"], pair["images"])
    ref = tq.forward_folded(tq.fold_batchnorm(pair["port"]), pair["images"])
    got = tq.forward(qp, pair["images"])
    err = (got.pose6d - ref.pose6d).abs().max().item()
    scale = ref.pose6d.abs().max().item() + 1e-6
    assert err / scale < 0.15, (err, scale)
    R = got.rotmats.reshape(-1, 3, 3).double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye, atol=1e-4,
                               rtol=0)
    for name, qc in _convs(qp):
        assert qc.w.dtype == torch.int8, name
        assert qc.w.abs().max() <= 127 and qc.w_scale.min() > 0, name
        assert qc.x_scale > 0, name


def test_quantized_hmr_moves_and_keeps_its_outputs(pair):
    model = tq.QuantizedHMR(tq.quantize_hmr(pair["port"], pair["images"]))
    moved = model.to("cpu")
    assert moved.qparams is not model.qparams
    a, b = model(pair["images"]), moved(pair["images"])
    for name in OUTPUTS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   atol=0, rtol=0)


def test_hmr_smpl_step_quantized_matches_tpubody():
    """hmr_smpl_step(quantize=True) on the CPU: its calibration scales
    equal tpubody's PTQ of the same float32 weights on the same default
    calibration images (rtol 1e-5), and with tpubody's int8 parameters
    carried in, its vertices equal tpubody's int8 forward then
    forward_batch_verts within 1e-4 (the repo's vertex budget)."""
    from tpubody.models import params as jparams
    from tpubody.models import smpl as jsmpl
    from tpubody_torch.pipelines import serving

    step = serving.hmr_smpl_step(quantize=True, device="cpu",
                                 image_size=SIZE, n_verts=300)
    assert isinstance(step.hmr, tq.QuantizedHMR)
    f32 = thmr.create_hmr(dtype=torch.float32, device="cpu")
    reference = {k[len("backbone."):] if k.startswith("backbone.") else k:
                 v.numpy() for k, v in f32.state_dict().items()
                 if not k.endswith("num_batches_tracked")}
    variables = jhmr.convert_torch_state_dict(reference,
                                              jhmr.default_mean_params())
    calib = np.random.default_rng(0).normal(scale=0.5,
                                            size=(4, SIZE, SIZE, 3))
    jqp = jq.quantize_hmr(variables, jnp.asarray(calib, jnp.float32))
    jqn = _np_tree(jqp)
    for (name, t), (_, j) in zip(_convs(step.hmr.qparams), _convs(jqn)):
        assert abs(float(t.x_scale) - float(j.x_scale)) \
            <= 1e-5 * float(j.x_scale), name

    step.hmr = tq.QuantizedHMR(tq.from_tpubody(jqn))
    images = np.random.default_rng(5).normal(
        size=(3, SIZE, SIZE, 3)).astype(np.float32)
    verts, cam = step(images)
    out = jq.forward(jqp, jnp.asarray(images))
    body = jparams.load_or_synthetic("smpl", n_joints=24, n_verts=300,
                                     seed=0, warn=False)
    want = np.asarray(jsmpl.forward_batch_verts(
        body, out.rotmats, out.shape, None, use_pallas=False,
        pose_is_rotmat=True))
    assert verts.shape == (3, 300, 3) and cam.shape == (3, 3)
    assert np.abs(verts.numpy() - want).max() < 1e-4
    assert np.abs(cam.numpy() - np.asarray(out.cam)).max() < 1e-4


def test_quantized_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpubody_torch.pipelines import serving

    with pytest.raises(RuntimeError, match="cuda"):
        serving.hmr_smpl_step(quantize=True)


def _eager_requant(monkeypatch, acc, qc, relu, res, scales):
    """The chain requantize replaces: _qconv's epilogue on these sums (its
    products replaced by them), the backbone's residual add and relu, then
    _quantize_input for each consumer scale."""
    monkeypatch.setattr(tq, "_mm_int8", lambda cols, w: acc)
    M = acc.shape[0]
    y = tq._qconv(qc, torch.zeros((1, M, 1, 8)), relu, "t", None).view(M, -1)
    if res is not None:
        y = y.add_(res).relu_()
    return [tq._quantize_input(y, s) for s in scales], y


@pytest.mark.parametrize("M", (1, 17, 1000))
@pytest.mark.parametrize("O", (64, 256, 2048))
@pytest.mark.parametrize("n_scales", (1, 2))
@pytest.mark.parametrize("keep", (False, True))
@pytest.mark.parametrize("with_res", (False, True))
@pytest.mark.parametrize("relu", (False, True))
def test_requantize_plain_equals_the_eager_chain(monkeypatch, relu, with_res,
                                                 keep, n_scales, O, M):
    acc, qc, res, scales = requant_case(M, O, n_scales, with_res, "cpu")
    want_codes, want_y = _eager_requant(monkeypatch, acc, qc, relu, res,
                                        scales)
    t = want_y[:, ::2] / TIE_SCALE          # exact on the even channels
    assert (t - t.floor() == 0.5).any() and (t.abs() > 127).any()
    codes, y = tq.requantize(acc, qc, relu, res, scales, keep)
    assert len(codes) == n_scales
    for c, w in zip(codes, want_codes):
        assert c.dtype == torch.int8 and torch.equal(c, w)
    if keep:
        assert torch.equal(y, want_y)
    else:
        assert y is None


@pytest.mark.parametrize("batch", (1, 2))
@pytest.mark.parametrize("source", ("tpubody", "seeded", "dn_scales_apart"))
def test_backbone_equals_the_eager_chain(pair, source, batch):
    """The 53 observed codes, in order, and the pooled features; no kernel
    launch on the CPU.  "tpubody": the pair's carried parameters, whose
    codes are all zero from l0_0's c2 on; "seeded": the port's PTQ of a
    seeded HMR, whose codes are not."""
    if source == "tpubody":
        qp = tq.from_tpubody(pair["qparams"])
    else:
        qp = tq.quantize_hmr(thmr.create_hmr(dtype=torch.float32, seed=3,
                                             device="cpu"), pair["images"])
    if source == "dn_scales_apart":
        qp = dn_scales_apart(qp)
    x = torch.as_tensor(pair["images"][:batch])
    got, want = [], []
    before = native.LAUNCHES["int8_requant"]
    feats = tq._backbone_int8(qp, x, lambda n, c: got.append((n, c)))
    assert native.LAUNCHES["int8_requant"] == before
    ref = eager_backbone(qp, x, lambda n, c: want.append((n, c)))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 53
    if source != "tpubody":
        assert all(c.abs().max() > 0 for _, c in got)
    for (name, c), (_, w) in zip(got, want):
        assert torch.equal(c, w), name
    assert torch.equal(feats, ref)
