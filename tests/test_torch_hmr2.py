"""tpubody_torch.models.hmr2 (HMR 2.0: ViT-H/16 + cross-attention decoder)
against the benchmark's plain float32 reference
(``benchmark/reference/hmr2_smpl.py``), which imports nothing of the port.

Weights come from ``benchmark/models/hmr2_vith.py`` (seeded, 4D-Humans'
names, non-trivial LayerNorms and biases so that a swap or a dropped term
shows).  float32 agreement: 1e-5 of each output's largest magnitude, at tiny
widths and at one block and one decoder layer of the published widths (the
same operations in another summation order read 1e-8 to 7e-7).  No JAX: the
reference is plain PyTorch, and the CUDA test runs on the card as it is.
"""
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import generate, harness
from benchmark.models import hmr2_vith, hmr_smpl_step, smpl_body
from benchmark.reference import hmr2_smpl, hmr_smpl
from tpubody_torch.core.rotations import rot6d_to_rotmat
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr2
from tpubody_torch.pipelines import hmr_infer, serving
from tpubody_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2 ** 33 + 5
PUBLISHED = harness.load_json(harness.HERE, "configs", "hmr2_vith_bf16.json")
# Tiny widths: a 64 x 48 crop of 64^2 images, 8 x 8 patches (48 tokens),
# dim 64 in 4 heads, 2 blocks; a 2-layer decoder of 4 heads of 16.
TINY = {**PUBLISHED, "image_size": 64, "crop_width": 48, "patch_size": 8,
        "embed_dim": 64, "head_dim": 16, "num_heads": 4, "mlp_dim": 256,
        "depth": 2, "context_dim": 64, "decoder_dim": 64,
        "decoder_depth": 2, "decoder_heads": 4, "decoder_dim_head": 16,
        "decoder_mlp_dim": 64, "smpl_vertices": 300}
REL = 1e-5


def widths(cfg):
    return harness.config_of("hmr2_vith_bf16")[1].widths(cfg)


def images(cfg, n=4, stream="t"):
    mix = harness.mix_of("offline_batches")
    return generate.images(mix["images"], n, cfg["image_size"], SEED,
                           stream, "cpu")


def rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max())


def sixd_port(pose_4dhumans):
    """4D-Humans' (2, 3) 6D layout -> the port's (3, 2)."""
    B = pose_4dhumans.shape[0]
    return pose_4dhumans.view(B, -1, 2, 3).transpose(2, 3).reshape(B, -1)


@pytest.fixture(scope="module")
def made():
    mean = hmr_smpl_step.mean_params(SEED, "cpu")
    weights = hmr2_vith.make(SEED, "cpu", TINY, mean)
    body = smpl_body.make(SEED, "cpu", n_verts=TINY["smpl_vertices"])
    return weights, body, mean


def port(cfg, weights, mean, dtype=torch.float32):
    model = hmr2.HMR2(mean.numpy(), **widths(cfg))
    model = hmr2.to_compute(model, dtype, torch.device("cpu"))
    return hmr2.load_reference_state_dict(model, weights)


def tiny_create(monkeypatch):
    """``hmr2.create_hmr2`` at TINY's widths, for the factories."""
    monkeypatch.setattr(hmr2, "create_hmr2", functools.partial(
        hmr2.create_hmr2, **widths(TINY)))


# -- the port against the reference -----------------------------------------
@pytest.mark.parametrize("route", ("HMRSMPLStep", "hmr_smpl_step"))
def test_port_matches_reference_float32(made, monkeypatch, route):
    weights, body, mean = made
    parents = smpl_body.SMPL_PARENTS
    if route == "HMRSMPLStep":
        step = serving.HMRSMPLStep(port(TINY, weights, mean),
                                   hmr_smpl_step.body_params(body),
                                   torch.device("cpu"), TINY["image_size"])
    else:
        tiny_create(monkeypatch)
        step = serving.hmr_smpl_step(arch="hmr2_vith", dtype=torch.float32,
                                     n_verts=TINY["smpl_vertices"],
                                     mean_params=mean.numpy(), device="cpu")
        hmr2.load_reference_state_dict(step.hmr, weights)
        b = step.body
        body = {"v_template": b.v_template, "shapedirs": b.shapedirs,
                "posedirs": b.posedirs, "j_regressor": b.j_regressor,
                "weights": b.weights}
        parents = b.parents
    x = images(TINY)
    verts, cam = step(x.numpy())
    with torch.no_grad():
        pose6d = step.hmr(x).pose6d
    want_v, want_cam = hmr2_smpl.forward(weights, body, parents, x, TINY)
    with torch.no_grad():
        want_pose = hmr2_smpl.regress(weights, x, TINY)[3]
    assert verts.shape == (4, TINY["smpl_vertices"], 3)
    assert rel(verts, want_v) < REL
    assert rel(cam, want_cam) < REL
    assert rel(pose6d, sixd_port(want_pose)) < REL


def test_bf16_path_is_within_its_bound_and_fp8_is_not(made):
    """The bf16 model (bf16 weights, ``to_compute``) against the float32
    reference on the same weights, as a share of how far the images move
    the answer (the largest distance of a frame's 6D pose and camera from
    the frames' mean).  The bound, 0.03: the bf16 path rounds the operands
    of every product a frame passes through (the patch convolution; 4
    Linears and the attention a block; 7 Linears and 2 attentions a
    decoder layer; unit roundoff 2^-9), about 0.2% of a value each, and the
    images move the answer by some ten times a value's rounding at these
    widths (read: 0.008).  The same reference with float8 operands
    (unit roundoff 2^-4, 16 times bf16's) must miss it (read: 0.105)."""
    weights, _, mean = made
    bf16 = hmr2_vith.served(weights, torch.bfloat16)
    x = images(TINY, n=8)
    with torch.no_grad():
        got = port(TINY, bf16, mean, torch.bfloat16)(x)
        want = hmr2_smpl.regress(bf16, x, TINY)
        fp8 = hmr2_smpl.regress(bf16, x, TINY, hmr_smpl.fp8)

    def share(out):
        errs = []
        for g, w in ((out[0], sixd_port(want[3])), (out[1], want[2])):
            spread = (w - w.mean(0)).abs().max()
            errs.append(float((g.float() - w).abs().max() / spread))
        return max(errs)

    assert share((got.pose6d, got.cam)) < 0.03
    assert share((sixd_port(fp8[3]), fp8[2])) > 0.03


def _one_part(cfg, part, weights, mean):
    """The published-width encoder with one block (and the patch embedding
    and ``last_norm`` around it), or the decoder with one layer over 192
    seeded context tokens of 1280: (port, reference) outputs."""
    model = port(cfg, weights, mean)
    with torch.no_grad():
        if part == "encoder block":
            x = images(cfg, n=2)
            return model.backbone(x), hmr2_smpl.vit(weights, x, cfg)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randn((2, 192, cfg["context_dim"]), generator=gen)
        return (model.smpl_head.transformer(torch.zeros(2, 1, 1), tokens),
                hmr2_smpl.decoder(weights, tokens, cfg)[:, None])


@pytest.mark.parametrize("part", ("encoder block", "decoder layer"))
def test_published_width_part_matches_reference(part):
    cfg = {**PUBLISHED, "depth": 1, "decoder_depth": 1}
    mean = hmr_smpl_step.mean_params(SEED, "cpu")
    weights = hmr2_vith.make(SEED, "cpu", cfg, mean)
    got, want = _one_part(cfg, part, weights, mean)
    assert got.shape == want.shape
    assert rel(got, want) < REL


# -- the crop, the grid, the names ------------------------------------------
def test_crop_and_patch_grid():
    """A 256^2 image gives 16 x 12 = 192 tokens; columns outside 32:224
    do not move the output."""
    model = hmr2.create_hmr2(dtype=torch.float32, device="cpu", dim=32,
                             depth=1, heads=2, mlp_dim=64, dec_dim=32,
                             dec_depth=1, dec_heads=2, dec_dim_head=16,
                             dec_mlp_dim=32)
    assert model.backbone.pos_embed.shape == (1, 193, 32)
    x = images(PUBLISHED, n=2)
    y = x.clone()
    y[:, :, :32] = 5.0
    y[:, :, 224:] = -5.0
    with torch.no_grad():
        tokens = model.backbone(x)
        a, b = model(x), model(y)
    assert tokens.shape == (2, 192, 32)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    z = x.clone()
    z[:, :, 32] += 1.0
    with torch.no_grad():
        assert not torch.equal(model(z).cam, a.cam)
    with pytest.raises(ValueError, match="256"):
        model(x[:, :, :224])


def test_state_dict_round_trip_under_4dhumans_names(made):
    weights, _, mean = made
    model = port(TINY, weights, mean)
    sd = model.state_dict()
    assert set(sd) == set(weights)
    for k, v in weights.items():
        assert torch.equal(sd[k], v), k
    again = hmr2.HMR2(thmr.identity_mean_params(), **widths(TINY))
    checkpoint = {**sd, "discriminator.fc.weight": torch.zeros(1),
                  "smpl.betas": torch.zeros(1)}
    hmr2.load_reference_state_dict(again, checkpoint)
    x = images(TINY, n=2)
    with torch.no_grad():
        for u, v in zip(model.eval()(x), again.eval()(x)):
            assert torch.equal(u, v)
    partial = {k: v for k, v in sd.items() if "blocks.1.mlp" not in k}
    with pytest.raises(KeyError, match="missing"):
        hmr2.load_reference_state_dict(again, partial)


def test_mean_params_reach_the_head_in_4dhumans_layout(made):
    """With the readout at zero the model returns its start: the port's
    6D layout in ``pose6d`` and ``mean_params``, 4D-Humans' in the
    ``init_body_pose`` buffer."""
    _, _, mean = made
    model = hmr2.HMR2(mean.numpy(), **widths(TINY))
    head = model.smpl_head
    want = hmr2_vith.mean_4dhumans(mean)
    for name in hmr2.MEAN_KEYS:
        assert torch.equal(getattr(head, name),
                           want["smpl_head." + name]), name
    for m in (head.decpose, head.decshape, head.deccam):
        torch.nn.init.zeros_(m.weight)
        torch.nn.init.zeros_(m.bias)
    with torch.no_grad():
        out = model.eval()(images(TINY, n=2))
    assert torch.equal(out.pose6d[0], mean[:144])
    assert torch.equal(out.cam[1], mean[154:157])
    torch.testing.assert_close(out.rotmats[0],
                               rot6d_to_rotmat(mean[:144].view(24, 6)))


# -- the normal path ----------------------------------------------------------
@pytest.mark.parametrize("arch", ("hmr_r50", "hmr2_vith"))
def test_identity_start_gives_orthonormal_columns(monkeypatch, arch):
    """From ``identity_mean_params`` (the default of ``hmr2_vith``, and
    ``mean_params=`` of ``hmr_r50``), with the readout at zero, every
    joint's 6D pose is two orthonormal columns; ``tpubody``'s
    ``default_mean_params`` is not."""
    tiny_create(monkeypatch)
    start = thmr.identity_mean_params()
    kw = {"mean_params": start} if arch == "hmr_r50" else {}
    step = serving.hmr_smpl_step(arch=arch, dtype=torch.float32,
                                 n_verts=300, image_size=64 if
                                 arch == "hmr_r50" else None, device="cpu",
                                 **kw)
    model = step.hmr
    head = model if arch == "hmr_r50" else model.smpl_head
    for m in (head.decpose, head.decshape, head.deccam):
        torch.nn.init.zeros_(m.weight)
        torch.nn.init.zeros_(m.bias)
    with torch.no_grad():
        out = model(images(TINY, n=2))
    cols = out.pose6d.view(2, 24, 3, 2)
    gram = cols.transpose(-1, -2) @ cols
    torch.testing.assert_close(gram, torch.eye(2).expand(2, 24, 2, 2))
    torch.testing.assert_close(out.rotmats, torch.eye(3).expand(2, 24, 3, 3))
    old = torch.as_tensor(thmr.default_mean_params()[:144]).view(24, 3, 2)
    assert not torch.allclose(old.transpose(-1, -2) @ old,
                              torch.eye(2).expand(24, 2, 2))


def test_factories_take_mean_params_and_refuse_int8(monkeypatch):
    tiny_create(monkeypatch)
    start = thmr.identity_mean_params()
    step = serving.hmr_smpl_step(arch="hmr_r50", dtype=torch.float32,
                                 image_size=64, n_verts=300,
                                 mean_params=start, device="cpu")
    assert np.array_equal(step.hmr.mean_params.numpy(), start)
    assert step.image_shape == (64, 64, 3)
    step = serving.hmr_smpl_step(arch="hmr2_vith", n_verts=300, device="cpu")
    assert step.image_shape == (64, 64, 3)
    assert step.hmr.backbone.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert step.hmr.smpl_head.decpose.weight.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="hmr2_vith"):
        serving.hmr_smpl_step(arch="hmr2_vith", quantize=True, device="cpu")
    with pytest.raises(ValueError, match="arch"):
        serving.hmr_smpl_step(arch="vit_b", device="cpu")
    with pytest.raises(ValueError, match="image_size"):
        serving.hmr_smpl_step(arch="hmr2_vith", image_size=224,
                              device="cpu")
    body = hmr_smpl_step.body_params(smpl_body.make(SEED, "cpu",
                                                    n_verts=120))
    pred = hmr_infer.HMRPredictor(smpl_model=body, dtype=torch.float32,
                                  device="cpu", arch="hmr2_vith")
    assert pred.img_size == 64
    res = pred(images(TINY, n=2))
    assert res.verts.shape == (2, 120, 3)
    assert torch.equal(pred.model.smpl_head.init_body_pose,
                       hmr2.HMR2(start, **widths(TINY))
                       .smpl_head.init_body_pose)


def test_step_replica_and_server(made):
    """``HMRSMPLStep.to()`` copies the new model; ``InferenceServer`` serves
    it by the same route as HMR."""
    weights, body, mean = made
    step = serving.HMRSMPLStep(port(TINY, weights, mean),
                               hmr_smpl_step.body_params(body),
                               torch.device("cpu"), TINY["image_size"])
    replica = step.to("cpu")
    assert replica.hmr is not step.hmr
    assert isinstance(replica.hmr, hmr2.HMR2)
    x = images(TINY, n=3).numpy()
    want_v, want_cam = step(x)
    got_v, got_cam = replica(x)
    assert torch.equal(got_v, want_v) and torch.equal(got_cam, want_cam)
    with serving.InferenceServer(step, image_shape=step.image_shape,
                                 buckets=(4,), device="cpu") as server:
        out = [server.submit(im) for im in x]
        served = [f.result(timeout=120) for f in out]
    for i, (v, c) in enumerate(served):
        np.testing.assert_allclose(v, want_v[i].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(c, want_cam[i].numpy(), rtol=0, atol=1e-5)


# -- spans ----------------------------------------------------------------
def test_spans_per_step():
    """Under a profiler session one step records ``hmr2.backbone`` and
    ``hmr2.head`` under ``step``, and 32 ``hmr2.attention`` and 32
    ``hmr2.mlp`` under the backbone, which they tile."""
    model = hmr2.create_hmr2(dtype=torch.float32, device="cpu",
                             image_size=64, crop_width=48, patch_size=8,
                             dim=16, depth=32, heads=2, mlp_dim=32,
                             dec_dim=16, dec_depth=1, dec_heads=2,
                             dec_dim_head=8, dec_mlp_dim=16)
    step = serving.HMRSMPLStep(model, hmr_smpl_step.body_params(
        smpl_body.make(SEED, "cpu", n_verts=120)), torch.device("cpu"), 64)
    x = images(TINY, n=2).numpy()
    plain = step(x)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            traced = step(x)
        records = profiling.spans()
    finally:
        profiling.clear()
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    root = records[0]
    assert root["name"] == "step" and root["parent"] is None
    names = [r["name"] for r in records if r["parent"] == root["id"]]
    assert names[:3] == ["step.h2d", "hmr2.backbone", "hmr2.head"]
    backbone = next(r for r in records if r["name"] == "hmr2.backbone")
    inner = [r for r in records if r["parent"] == backbone["id"]]
    assert [r["name"] for r in inner] == ["hmr2.attention", "hmr2.mlp"] * 32
    assert 0 < sum(r["device_ms"] for r in inner) <= backbone["device_ms"]


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backends", (
    ("FLASH_ATTENTION", "EFFICIENT_ATTENTION"),
    ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")))
def test_cuda_bf16_attention_takes_a_fused_kernel(cuda, backends):
    """The encoder's attention at (B, 16, 192, 80) and the decoder's
    single-query cross-attention over 192 tokens run in bf16 under
    ``sdpa_kernel`` with the math path left out, which raises rather than
    fall back to it, and agree with the reference's softmax(Q K^T) V in
    float32 to bf16's rounding.  The second set is what the normal path
    picks from (its trace shows cuDNN's fused kernel)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=cuda).manual_seed(3)
    shapes = {"encoder": ((8, 16, 192, 80),) * 3,
              "decoder": ((8, 8, 1, 64), (8, 8, 192, 64), (8, 8, 192, 64))}
    for name, (sq, sk, sv) in shapes.items():
        q, k, v = (torch.randn(s, generator=gen, device=cuda)
                   for s in (sq, sk, sv))
        with sdpa_kernel([getattr(SDPBackend, b) for b in backends]):
            got = torch.nn.functional.scaled_dot_product_attention(
                q.bfloat16(), k.bfloat16(), v.bfloat16())
        want = hmr2_smpl.attention(q, k, v)
        B, _, N, _ = got.shape
        got = got.transpose(1, 2).reshape(B, N, -1).float()
        assert rel(got.cpu(), want.cpu()) < 2e-2, name
