"""tpubody_torch.models.sapiens (Sapiens pose: ``hmr2.ViTH`` at Sapiens'
widths and the deconvolution heatmap head) and its serving step against the
benchmark's plain float32 reference (``benchmark/reference/sapiens_pose.py``),
which imports nothing of the port.

Weights come from ``benchmark/models/sapiens_vit.py`` (seeded, Sapiens'
names, LayerNorms and BatchNorms away from their initial values so that a
dropped or swapped term shows).  Tiny widths with heads that are not a
multiple of 8 wide: 64^2 frames whose middle 48 columns are read (a 4 x 3
grid of 16-pixel patches), dim 60 in 4 heads of 15 (padded to 16), 2
blocks, a head of 16 channels and 5 keypoints on 16 x 12 heatmaps.
float32 agreement: 1e-5 of each output's largest magnitude; bf16 within a
share of the frames' spread, where float8 operands are further.  The old
ViT path (HMR 2.0's) keeps its spans and its bits.  No JAX: the reference
is plain PyTorch, and the CUDA tests run on the card as it is.
"""
import functools

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, generate, harness
from benchmark.models import sapiens_vit
from benchmark.reference import hmr_smpl, sapiens_pose
from tpubody_torch import native
from tpubody_torch.models import hmr2, pose2d, sapiens
from tpubody_torch.pipelines import serving
from tpubody_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2 ** 33 + 26
CONFIG = "sapiens_2b_pose_bf16"
CELL = "sapiens2b_bf16.offline_b32"
PUBLISHED = harness.load_json(harness.HERE, "configs", CONFIG + ".json")
TINY = {**PUBLISHED, "image_size": 64, "crop_width": 48, "embed_dim": 60,
        "num_heads": 4, "head_dim": 15, "mlp_dim": 120, "depth": 2,
        "deconv_channels": [16, 16], "conv_channels": [16, 16],
        "keypoints": 5}
# The final layer's gain of the seeded weights at tiny widths: 16 x 12
# heatmaps are flatter than 256 x 192 ones at the published gain, which
# would clamp every confidence at 1 here.
TINY_FINAL_GAIN = 0.5
REL = 1e-5
# bf16 against float32 as a share of the frames' spread, the keypoints and
# the confidences: 0.04-0.07 and 0.08-0.10 read at these widths on 4 and 8
# frames, float8 operands 0.77-1.0 and 2.2-2.4.
BF16_BOUND = (0.1, 0.25)


def config():
    return harness.config_of(CONFIG)[1]


def widths(cfg):
    return config().widths(cfg)


def images(cfg, n=3, stream="t"):
    mix = harness.mix_of("offline_batches_b32")
    return generate.images(mix["images"], n, cfg["image_size"], SEED,
                           stream, "cpu")


def rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max())


def spread_share(got, want):
    """The largest difference over how far the frames' answers move."""
    want = torch.as_tensor(want).double()
    spread = (want - want.mean(0)).pow(2).mean().sqrt()
    return float((torch.as_tensor(got).double() - want).abs().max() / spread)


@pytest.fixture(scope="module")
def weights():
    published_gain = sapiens_vit.FINAL_GAIN
    sapiens_vit.FINAL_GAIN = TINY_FINAL_GAIN
    try:
        return sapiens_vit.make(SEED, "cpu", TINY)
    finally:
        sapiens_vit.FINAL_GAIN = published_gain


def port(cfg, weights, dtype=torch.float32):
    model = sapiens.to_compute(sapiens.SapiensPose(**widths(cfg)), dtype,
                               torch.device("cpu"))
    return sapiens.load_reference_state_dict(model, weights)


def step_of(cfg, weights, dtype=torch.float32):
    return serving.KeypointStep(port(cfg, weights, dtype),
                                torch.device("cpu"), cfg["image_size"])


# -- the port against the reference -----------------------------------------
@pytest.mark.parametrize("route", ("KeypointStep", "keypoint_step"))
def test_port_matches_reference_float32(weights, monkeypatch, route):
    if route == "KeypointStep":
        step = step_of(TINY, weights)
    else:
        monkeypatch.setattr(sapiens, "create_sapiens_pose", functools.partial(
            sapiens.create_sapiens_pose, **widths(TINY)))
        step = serving.keypoint_step(arch="sapiens_2b_pose",
                                     dtype=torch.float32, device="cpu")
        sapiens.load_reference_state_dict(step.model, weights)
    x = images(TINY)
    keypoints, conf = step(x.numpy())
    want_k, want_c = sapiens_pose.forward(weights, x, TINY)
    assert keypoints.shape == (3, 5, 2) and conf.shape == (3, 5)
    assert keypoints.dtype == conf.dtype == torch.float32
    assert rel(keypoints, want_k) < REL
    assert rel(conf, want_c) < REL
    assert bool(((conf > 0) & (conf < 1)).all())


def test_bf16_path_is_within_its_bound_and_fp8_is_not(weights):
    """The bf16 step against the float32 reference on the same weights, as
    a share of the frames' spread: keypoints within 0.1, confidences within
    0.25; the reference with float8 operands (the benchmark's control)
    three times further than the bf16 step."""
    x = images(TINY, n=4)
    got = step_of(TINY, weights, torch.bfloat16)(x.numpy())
    want = sapiens_pose.forward(weights, x, TINY)
    fp8 = sapiens_pose.forward(weights, x, TINY, hmr_smpl.fp8)
    for g, f, w, bound in zip(got, fp8, want, BF16_BOUND):
        share = spread_share(g, w)
        assert share < bound
        assert spread_share(f, w) > 3 * share


# -- heads of 15: padded to 16 ----------------------------------------------
def test_padded_heads_match_unpadded_attention():
    """Heads of 15 padded to 16 (zero rows in ``qkv``, zero columns in
    ``proj``, the scale 15^-1/2) against the same published weights run
    unpadded, float32: within 1e-6 of the output's largest magnitude."""
    attn = hmr2.Attention(60, 4)
    assert (attn.head_dim, attn.padded) == (15, 16)
    assert attn.qkv.weight.shape == (192, 60)
    gen = torch.Generator().manual_seed(26)
    sd = {k: torch.randn(v.shape, generator=gen)
          for k, v in attn.state_dict().items()}
    attn.load_state_dict(sd)
    x = torch.randn(2, 12, 60, generator=gen)
    qkv = nn.functional.linear(x, sd["qkv.weight"], sd["qkv.bias"])
    q, k, v = qkv.view(2, 12, 3, 4, 15).permute(2, 0, 3, 1, 4)
    y = torch.softmax(q @ k.transpose(-1, -2) * 15 ** -0.5, -1) @ v
    want = nn.functional.linear(y.transpose(1, 2).reshape(2, 12, 60),
                                sd["proj.weight"], sd["proj.bias"])
    with torch.no_grad():
        got = attn(x)
    assert rel(got, want) < 1e-6
    pads = attn.qkv.weight.view(3, 4, 16, 60)[:, :, 15:]
    assert not pads.any() and not attn.qkv.bias.view(3, 4, 16)[:, :, 15:].any()
    assert not attn.proj.weight.view(60, 4, 16)[:, :, 15:].any()


def test_scale_of_the_padded_width_is_caught(weights):
    """Heads of 15 scaled by the padded width's 16^-1/2 instead: the
    float32 step is then far from the reference (the cell's bf16 limits do
    not see this fault at the published widths; this bar does)."""
    step = step_of(TINY, weights)
    for block in step.model.backbone.blocks:
        block.attn.head_dim = block.attn.padded
    x = images(TINY)
    keypoints, conf = step(x.numpy())
    want_k, want_c = sapiens_pose.forward(weights, x, TINY)
    assert max(rel(keypoints, want_k), rel(conf, want_c)) > 100 * REL


def test_padded_state_dict_round_trips_at_the_published_shapes():
    """Sapiens' 32 heads of 60 held as 64: the state dict saves and loads
    the published (5760, 1920) ``qkv`` and (1920, 1920) ``proj``."""
    attn = hmr2.Attention(1920, 32)
    assert attn.qkv.weight.shape == (6144, 1920)
    sd = attn.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "qkv.weight": (5760, 1920), "qkv.bias": (5760,),
        "proj.weight": (1920, 1920), "proj.bias": (1920,)}
    gen = torch.Generator().manual_seed(1)
    new = {k: torch.randn(v.shape, generator=gen) for k, v in sd.items()}
    attn.load_state_dict(new)
    back = attn.state_dict()
    assert all(torch.equal(back[k], new[k]) for k in new)
    # HMR 2.0's 80 and Multi-HMR's 64 take no padding
    for dim, heads in ((1280, 16), (1024, 16)):
        plain = hmr2.Attention(dim, heads)
        assert plain.padded == plain.head_dim
        assert plain.qkv.weight.shape == (3 * dim, dim)


# -- the head ---------------------------------------------------------------
def published_head(cfg, weights):
    """mmpose's ``HeatmapHead`` as published, BatchNorm unfolded, loaded
    by its names: (deconv, BatchNorm, ReLU) x 2, (conv, BatchNorm, ReLU) x
    2, the final convolution."""
    c = cfg["embed_dim"]
    deconv, conv = [], []
    for c_out in cfg["deconv_channels"]:
        deconv += [nn.ConvTranspose2d(c, c_out, 4, 2, 1, bias=False),
                   nn.BatchNorm2d(c_out), nn.ReLU()]
        c = c_out
    for c_out in cfg["conv_channels"]:
        conv += [nn.Conv2d(c, c_out, 1), nn.BatchNorm2d(c_out), nn.ReLU()]
        c = c_out
    head = nn.Module()
    head.deconv_layers = nn.Sequential(*deconv)
    head.conv_layers = nn.Sequential(*conv)
    head.final_layer = nn.Conv2d(c, cfg["keypoints"], 1)
    missing, unexpected = head.load_state_dict(
        {k[5:]: v.float() for k, v in weights.items()
         if k.startswith("head.")}, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return head.eval()


def test_batchnorm_fold_matches_batchnorm_as_published(weights):
    """The folded head against ``nn.BatchNorm2d`` in eval mode after each
    convolution, loaded by the published names, and against the
    reference's head, on the same tokens: within 1e-5; the seeded
    BatchNorms are far from the identity, so the fold is seen."""
    model = port(TINY, weights)
    tokens = torch.randn(2, 12, 60, generator=torch.Generator().manual_seed(3))
    head = published_head(TINY, weights)
    x = tokens.transpose(1, 2).reshape(2, 60, 4, 3)
    with torch.no_grad():
        got = model.head(tokens)
        want = head.final_layer(head.conv_layers(head.deconv_layers(x)))
    assert got.shape == (2, 16, 12, 5)
    assert rel(got, want.permute(0, 2, 3, 1)) < REL
    assert rel(got, sapiens_pose.head(weights, tokens, TINY).permute(
        0, 2, 3, 1)) < REL
    for name in ("head.deconv_layers.1", "head.conv_layers.4"):
        scale = weights[name + ".weight"] / torch.sqrt(
            weights[name + ".running_var"] + sapiens.BN_EPS)
        assert float((scale - 1).abs().max()) > 0.3


def test_forward_keeps_the_detector_contract(weights):
    """``SapiensPose.forward`` is ``pose2d.Pose2D.forward``'s contract:
    NHWC images in, (B, H/4, W/4, K) NHWC float32 logits out, so
    ``pose2d.detect`` reads it; ``decode`` is its soft-argmax in the
    frame's pixels (the crop's offset added)."""
    model = port(TINY, weights)
    x = images(TINY, n=2)
    with torch.no_grad():
        logits = model(x)
        found = pose2d.detect(model, x)
        keypoints, conf = model.decode(logits)
    assert logits.shape == (2, 16, 12, 5) and logits.dtype == torch.float32
    assert torch.equal(found.heatmaps, logits)
    assert found.keypoints.shape == (2, 5, 3)
    offset = torch.tensor([8.0, 0.0])
    assert torch.equal(keypoints, found.keypoints[..., :2] + offset)
    assert torch.equal(conf, found.keypoints[..., 2])
    assert bool((keypoints[..., 0] >= 8).all()
                and (keypoints[..., 0] < 56).all())
    with pytest.raises(ValueError, match="64"):
        model(torch.zeros(1, 32, 32, 3))


# -- weights and names ------------------------------------------------------
def test_state_dict_names_and_published_count(weights):
    model = port(TINY, weights)
    names = sapiens.published_names(model)
    assert set(names) == set(weights) - {
        k for k in weights if k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in weights.items()} == names
    assert torch.equal(model.backbone.blocks[1].mlp.fc2.weight,
                       weights["backbone.layers.1.ffn.layers.1.weight"])
    assert torch.equal(model.backbone.last_norm.bias,
                       weights["backbone.ln1.bias"])
    assert model.backbone.pos_embed.shape == (1, 12, 60)
    with pytest.raises(KeyError, match="missing"):
        sapiens.load_reference_state_dict(model, {
            k: v for k, v in weights.items() if "conv_layers.4" not in k})
    assert sapiens_vit.parameter_count(PUBLISHED) == \
        PUBLISHED["encoder_parameters"] == 2_131_943_040
    assert sapiens_vit.parameter_count(PUBLISHED, "head.") == \
        PUBLISHED["head_parameters"] == 34_454_324


def test_seeded_model_is_mmposes_init():
    model = sapiens.create_sapiens_pose(torch.float32, seed=3, device="cpu",
                                        **widths(TINY))
    head = model.head
    assert float(head.final_layer.weight.detach().std()) < 0.003
    assert not head.final_layer.bias.any()
    assert float(model.backbone.blocks[0].attn.qkv.weight.detach().std()) \
        < 0.03
    same = sapiens.create_sapiens_pose(torch.float32, seed=3, device="cpu",
                                       **widths(TINY))
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), same.state_dict().values()))


# -- serving ------------------------------------------------------------------
def test_step_replica_and_server(weights):
    """``KeypointStep`` answers (N, K, 2) keypoints and (N, K)
    confidences; its replica the same; ``InferenceServer`` gives each
    request its frame's (K, 2) and (K,)."""
    step = step_of(TINY, weights)
    replica = step.to("cpu")
    assert replica.model is not step.model
    x = images(TINY, n=3).numpy()
    want_k, want_c = step(x)
    got_k, got_c = replica(x)
    assert torch.equal(got_k, want_k) and torch.equal(got_c, want_c)
    with serving.InferenceServer(step, image_shape=step.image_shape,
                                 buckets=(1, 4), device="cpu") as server:
        served = [f.result(timeout=120)
                  for f in [server.submit(im) for im in x]]
    for i, (k, c) in enumerate(served):
        assert k.shape == (5, 2) and c.shape == (5,)
        np.testing.assert_allclose(k, want_k[i].numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(c, want_c[i].numpy(), rtol=0, atol=1e-6)


def test_factory_refuses_other_archs():
    with pytest.raises(ValueError, match="sapiens_2b_pose"):
        serving.keypoint_step(arch="sapiens_1b_pose", device="cpu")


def test_spans_per_step(weights):
    """Under a profiler session one step records ``step.h2d``,
    ``sapiens.backbone``, ``sapiens.head`` and ``sapiens.decode`` under
    ``step``, one ``sapiens.attention`` and one ``sapiens.mlp`` a block
    under the backbone, and no ``hmr2`` span."""
    step = step_of(TINY, weights)
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
    assert names == ["step.h2d", "sapiens.backbone", "sapiens.head",
                     "sapiens.decode"]
    backbone = next(r for r in records if r["name"] == "sapiens.backbone")
    inner = [r["name"] for r in records if r["parent"] == backbone["id"]]
    assert inner == ["sapiens.attention", "sapiens.mlp"] * TINY["depth"]
    assert not any(r["name"].startswith("hmr2.") for r in records)


def test_chunked_backbone_under_one_head_is_the_forward(weights):
    """The shared copy in: the backbone in chunks of 2 frames (the last
    ragged) under one head and decode equals the one-shot step."""
    step = step_of(TINY, weights)
    x = images(TINY, n=5).numpy()
    with torch.inference_mode():
        got = step.model.decode(step.model.head(
            step._backbone_in_chunks(x, 2)))
    want = step(x)
    for a, b in zip(got, want):
        assert rel(a, b) < REL


# -- the old ViT path -------------------------------------------------------
TINY_HMR2 = dict(image_size=32, crop_width=24, patch_size=8, dim=16,
                 depth=2, heads=2, mlp_dim=32)


def parent_vith_forward(vit, images):
    """``ViTH.forward`` as it was before Sapiens' options, verbatim but
    for its spans."""
    lo = (vit.image_size - vit.crop_width) // 2
    x = vit.patch_embed(images[:, :, lo:lo + vit.crop_width])
    x = x + (vit.pos_embed[:, 1:] + vit.pos_embed[:, :1])
    first = vit.blocks[0]
    h = first.norm1(x).to(first.attn.qkv.weight.dtype)
    for block, nxt in zip(vit.blocks, [*vit.blocks[1:], None]):
        x, h = hmr2.add_layernorm(x, block.attn(h), block.norm2,
                                  block.mlp.fc1.weight.dtype)
        if nxt is None:
            return hmr2.add_layernorm(x, block.mlp(h), vit.last_norm,
                                      torch.float32, keep_x=False)[1]
        x, h = hmr2.add_layernorm(x, block.mlp(h), nxt.norm1,
                                  nxt.attn.qkv.weight.dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_hmr2_encoder_keeps_its_bits_and_spans(dtype):
    """HMR 2.0's ``ViTH`` (heads of 8, a cls entry in the position table)
    gives the parent's bits and records ``hmr2.backbone`` once and
    ``hmr2.attention`` and ``hmr2.mlp`` once a block."""
    model = hmr2.create_hmr2(dtype=dtype, device="cpu", **TINY_HMR2,
                             dec_dim=16, dec_depth=1, dec_heads=2,
                             dec_dim_head=8, dec_mlp_dim=16)
    vit = model.backbone
    assert vit.pos_embed.shape == (1, 1 + 12, 16)
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(2, 32, 32, 3)).astype(np.float32))
    profiling.clear()
    try:
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU]):
            got = vit(x)
        records = profiling.spans()
    finally:
        profiling.clear()
    with torch.inference_mode():
        assert torch.equal(got, parent_vith_forward(vit, x))
    names = [r["name"] for r in records]
    assert names.count("hmr2.backbone") == 1
    assert names.count("hmr2.attention") == names.count("hmr2.mlp") == 2
    assert not any(n.startswith("sapiens.") for n in names)


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the published widths run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bf16_step_against_the_reference_at_a_chunk(cuda):
    """The cell's step at the published widths on one 16-frame chunk of
    1024^2 frames from host memory, against the float32 reference on the
    same seeded weights: within the cell's limits (the comparison of
    ``benchmark/compare.py``), 96 ``add_layernorm`` launches, the decode's
    two ``soft_argmax`` launches, (16, 308, 2) keypoints and (16, 308)
    confidences inside (0, 1)."""
    cfg, cell_config = harness.config_of(CONFIG)
    inputs = cell_config.make_inputs(cfg, SEED, cuda)
    step = cell_config.build(cfg, inputs, cuda)
    x = generate.images(harness.mix_of("offline_batches_b32")["images"], 16,
                        cfg["image_size"], SEED, "traffic.batch0", cuda)
    host = x.cpu().numpy()
    native.reset_launches()
    keypoints, conf = step(host)
    torch.cuda.synchronize()
    assert native.LAUNCHES["add_layernorm"] == 96
    assert native.LAUNCHES["soft_argmax"] == 2
    assert keypoints.shape == (16, 308, 2) and conf.shape == (16, 308)
    assert bool(((conf > 0) & (conf < 1)).all())
    ref = tuple(t.cpu().numpy() for t in
                cell_config.reference(cfg, inputs)(x))
    got = (keypoints.cpu().numpy(), conf.cpu().numpy())
    correct, checks = compare.check([(0, 0, got)], [ref], cfg["limits"],
                                    cuda)
    assert correct, checks
