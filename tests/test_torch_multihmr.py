"""tpubody_torch.models.multihmr (Multi-HMR: DINOv2 ViT-L/14 + the Human
Prediction Head, SMPL-X) against the benchmark's plain float32 reference
(``benchmark/reference/multihmr_smplx.py``), which imports nothing of the
port.

Weights come from ``benchmark/models/multihmr_vitl.py`` (seeded, Multi-HMR's
names, LayerScale, LayerNorms and biases away from their initial values so
that a dropped or swapped term shows).  float32 agreement: 1e-5 of each
output's largest magnitude at tiny widths (a 56^2 image of 14 x 14 patches,
dim 64 in 4 heads, 2 blocks, 2 persons); bf16 within 0.05 of the frames'
spread, where float8 operands are further.  No JAX: the reference is plain
PyTorch, and the CUDA tests run on the card as it is.
"""
import functools
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import generate, harness
from benchmark.models import multihmr_vitl, smplx_body
from benchmark.reference import hmr_smpl, multihmr_smplx
from tpubody_torch import native
from tpubody_torch.models import hmr2, multihmr
from tpubody_torch.pipelines import serving
from tpubody_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2 ** 33 + 23
CONFIG = "multihmr_896_l_bf16"
PUBLISHED = harness.load_json(harness.HERE, "configs", CONFIG + ".json")
# Tiny widths: 56^2 images, a 4 x 4 grid of 14 x 14 patches (17 tokens),
# dim 64 in 4 heads, 2 blocks, a 3 x 3 position table; a 2-layer head of 4
# heads of 16; 2 persons; a 300-vertex SMPL-X body.
TINY = {**PUBLISHED, "image_size": 56, "embed_dim": 64, "head_dim": 16,
        "num_heads": 4, "mlp_dim": 256, "depth": 2, "pos_embed_grid": 3,
        "context_dim": 64 + 99, "hph_dim": 64, "hph_heads": 4,
        "hph_dim_head": 16, "hph_mlp_dim": 64, "token_dim": 64 + 99 + 331,
        "persons": 2, "centres": [5, 14], "smpl_vertices": 300}
REL = 1e-5
BF16_BOUND = 0.05


def config():
    return harness.config_of(CONFIG)[1]


def widths(cfg):
    return config().widths(cfg)


def images(cfg, n=3, stream="t"):
    mix = harness.mix_of("offline_batches_b64")
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
def made():
    mean = multihmr_vitl.mean_params(SEED, "cpu", TINY)
    weights = multihmr_vitl.make(SEED, "cpu", TINY, mean)
    body = smplx_body.make(SEED, "cpu", n_verts=TINY["smpl_vertices"])
    return weights, body, mean


def port(cfg, weights, mean, dtype=torch.float32):
    model = multihmr.MultiHMR(mean.numpy(), **widths(cfg))
    model = multihmr.to_compute(model, dtype, torch.device("cpu"))
    return multihmr.load_reference_state_dict(model, weights)


def step_of(cfg, made, dtype=torch.float32):
    weights, body, mean = made
    return serving.HMRSMPLStep(port(cfg, weights, mean, dtype),
                               config().body_params(body),
                               torch.device("cpu"), cfg["image_size"])


def reference(cfg, made, x, operand=hmr_smpl.exact):
    weights, body, _ = made
    return multihmr_smplx.forward(weights, body, smplx_body.SMPLX_PARENTS,
                                  x, cfg, operand)


# -- the port against the reference -----------------------------------------
@pytest.mark.parametrize("route", ("HMRSMPLStep", "hmr_smpl_step"))
def test_port_matches_reference_float32(made, monkeypatch, route):
    weights, body, mean = made
    if route == "HMRSMPLStep":
        step = step_of(TINY, made)
    else:
        monkeypatch.setattr(multihmr, "create_multihmr", functools.partial(
            multihmr.create_multihmr, **widths(TINY)))
        step = serving.hmr_smpl_step(arch="multihmr_896_l",
                                     dtype=torch.float32,
                                     n_verts=TINY["smpl_vertices"],
                                     mean_params=mean.numpy(), device="cpu")
        multihmr.load_reference_state_dict(step.hmr, weights)
        b = step.body
        body = {k: getattr(b, k) for k in ("v_template", "shapedirs",
                                           "expr_dirs", "posedirs",
                                           "j_regressor", "weights")}
        made = (weights, body, mean)
    x = images(TINY)
    verts, transl = step(x.numpy())
    want_v, want_t = reference(TINY, made, x)
    assert verts.shape == (3, 2, TINY["smpl_vertices"], 3)
    assert transl.shape == (3, 2, 3)
    assert rel(verts, want_v) < REL
    assert rel(transl, want_t) < REL


def test_bf16_path_is_within_its_bound_and_fp8_is_not(made):
    """The bf16 step against the float32 reference on the same weights, as
    a share of the frames' spread: within 0.05; the reference with float8
    operands (the benchmark's control) further than the bf16 step."""
    x = images(TINY, n=4)
    got = step_of(TINY, made, torch.bfloat16)(x.numpy())
    want = reference(TINY, made, x)
    fp8 = reference(TINY, made, x, hmr_smpl.fp8)
    for g, f, w in zip(got, fp8, want):
        share = spread_share(g, w)
        assert share < BF16_BOUND
        assert spread_share(f, w) > share


def test_position_table_is_resized_once_with_its_cls_entry(made):
    weights, _, mean = made
    model = port(TINY, weights, mean)
    vit = model.backbone.encoder
    table = vit.pos_table
    assert table.shape == (1, 1 + 16, 64)
    assert torch.equal(table[:, 0], vit.pos_embed[:, 0])
    want = multihmr_smplx.position_table(weights, TINY)
    assert torch.allclose(table, want, rtol=0, atol=1e-6)
    # the same grid: the bicubic resize is the identity
    same = multihmr.DinoViT(image_size=42, patch_size=14, dim=8, depth=1,
                            heads=2, mlp_dim=16, pos_grid=3)
    with torch.no_grad():
        same.pos_embed.normal_()
    same.interpolate_pos_embed()
    assert torch.allclose(same.pos_table, same.pos_embed, atol=1e-6)
    with torch.no_grad():
        vit.pos_embed.mul_(2)
    assert torch.equal(vit.pos_table, table)       # no resize per forward


def test_ray_encoding_has_99_channels():
    """The published sizes: f = 448 / tan 30 degrees; 99 channels a patch,
    ``[d, sin(pi f_k d_i), cos(pi f_k d_i)]``, f from 1 to 32 in 16 bands."""
    K = multihmr.intrinsics(896, 60.0)
    assert math.isclose(float(K[0, 0]), 448 / math.tan(math.pi / 6))
    d = multihmr.patch_rays(896, 14, 60.0)
    assert d.shape == (4096, 3)
    u = v = 7.0
    assert torch.allclose(d[0], torch.tensor(
        [(u - 448) / K[0, 0], (v - 448) / K[1, 1], 1.0], dtype=d.dtype))
    assert torch.allclose(d[1, :2], torch.tensor(
        [(21 - 448) / K[0, 0], (7 - 448) / K[1, 1]], dtype=d.dtype))
    enc = multihmr.ray_encoding(d)
    assert enc.shape == (4096, 99)
    f = torch.linspace(1, 32, 16, dtype=d.dtype)
    assert torch.equal(enc[:, :3], d)
    assert torch.allclose(enc[:, 3:19], torch.sin(math.pi * d[:, :1] * f))
    assert torch.allclose(enc[:, 51:67], torch.cos(math.pi * d[:, :1] * f))
    assert torch.allclose(enc[:, 35:51], torch.sin(math.pi * d[:, 2:] * f))
    ref = multihmr_smplx.ray_features(PUBLISHED, "cpu")
    assert torch.allclose(enc.float(), ref, atol=1e-6)


def test_layerscale_reaches_the_stream(made):
    """LayerScale scales each branch: the encoder at the seeded gammas
    equals the reference, and the same model with the gammas at 1 (as if
    LayerScale were dropped) is far from it."""
    weights, _, mean = made
    model = port(TINY, weights, mean)
    x = images(TINY)
    with torch.no_grad():
        got = model.backbone(x)
        want = multihmr_smplx.vit(weights, x, TINY)
        assert rel(got, want) < REL
        for block in model.backbone.encoder.blocks:
            block.ls1.gamma.fill_(1.0)
            block.ls2.gamma.fill_(1.0)
        dropped = model.backbone(x)
    assert got.shape == (3, 16, 64)
    assert rel(dropped, want) > 0.05


def test_centres_given_per_call(made):
    """Each image's own centres, and two persons swapped: the answers come
    in the order of the centres given."""
    weights, _, mean = made
    model = port(TINY, weights, mean)
    x = images(TINY)
    centres = torch.tensor([[0, 15], [7, 3], [9, 9]])
    with torch.no_grad():
        out = model(x, centres)
        swapped = model(x, centres[:, [1, 0]])
        default = model(x)
    rot, coeffs, place = multihmr_smplx.regress(weights, x, centres, TINY)
    assert rel(out.rotmats, rot.flatten(0, 1)) < REL
    assert rel(out.shape, coeffs.flatten(0, 1)) < REL
    assert rel(out.cam, place.flatten(0, 1)) < REL
    flip = torch.tensor([1, 0, 3, 2, 5, 4])
    assert torch.equal(swapped.cam, out.cam[flip])
    assert default.cam.shape == (6, 3) and model.persons == 2
    with pytest.raises(ValueError, match="grid"):
        multihmr.MultiHMR(mean.numpy(), **{**widths(TINY),
                                           "centres": (16,)})


def test_state_dict_round_trip_under_multihmr_names(made):
    weights, _, mean = made
    model = port(TINY, weights, mean)
    sd = model.state_dict()
    assert set(sd) == set(weights)
    for name in ("backbone.encoder.blocks.1.ls2.gamma",
                 "backbone.encoder.blocks.0.attn.qkv.weight",
                 "backbone.encoder.cls_token", "backbone.encoder.norm.bias",
                 "x_attention_head.transformer.transformer.layers.1.1.fn."
                 "to_kv.weight", "x_attention_head.decexpression.weight",
                 "x_attention_head.mlp_offset.2.weight"):
        assert torch.equal(sd[name], weights[name].float())
    with pytest.raises(KeyError, match="missing"):
        multihmr.load_reference_state_dict(model, {
            k: v for k, v in weights.items() if "ls1" not in k})


def test_step_replica_and_server(made):
    """``HMRSMPLStep`` answers (N, P, V, 3) vertices and (N, P, 3)
    translations; its replica the same; ``InferenceServer`` gives each
    request its frame's (P, V, 3) and (P, 3)."""
    step = step_of(TINY, made)
    replica = step.to("cpu")
    assert replica.hmr is not step.hmr
    x = images(TINY, n=3).numpy()
    want_v, want_t = step(x)
    got_v, got_t = replica(x)
    assert torch.equal(got_v, want_v) and torch.equal(got_t, want_t)
    with serving.InferenceServer(step, image_shape=step.image_shape,
                                 buckets=(4,), device="cpu") as server:
        served = [f.result(timeout=120)
                  for f in [server.submit(im) for im in x]]
    for i, (v, t) in enumerate(served):
        assert v.shape == (2, TINY["smpl_vertices"], 3) and t.shape == (2, 3)
        np.testing.assert_allclose(v, want_v[i].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(t, want_t[i].numpy(), rtol=0, atol=1e-5)


def test_translation_places_the_head_joint(made):
    """The step's translation puts the posed head joint (15) at the
    model's placement."""
    from tpubody_torch.models import smpl

    step = step_of(TINY, made)
    x = images(TINY, n=2)
    with torch.no_grad():
        out = step.hmr(x)
    verts, transl = step(x.numpy())
    state = smpl.forward(step.body, out.rotmats, out.shape,
                         transl.reshape(-1, 3), pose_is_rotmat=True)
    head = state.joints_posed[:, 15] + transl.reshape(-1, 3)
    assert torch.allclose(head, out.cam, atol=1e-5)
    assert torch.allclose(state.verts, verts.reshape(state.verts.shape),
                          atol=1e-5)


@pytest.mark.parametrize("arch", serving.ARCHS[:2])
def test_single_person_models_keep_their_shapes(monkeypatch, arch):
    """HMR and HMR 2.0 still answer (N, V, 3) and (N, 3)."""
    if arch == "hmr2_vith":
        monkeypatch.setattr(hmr2, "create_hmr2", functools.partial(
            hmr2.create_hmr2, image_size=32, crop_width=24, patch_size=8,
            dim=16, depth=1, heads=2, mlp_dim=32, dec_dim=16, dec_depth=1,
            dec_heads=2, dec_dim_head=8, dec_mlp_dim=16))
        size = 32
    else:
        size = 64
    step = serving.hmr_smpl_step(arch=arch, dtype=torch.float32, n_verts=90,
                                 image_size=size, device="cpu")
    verts, cam = step(np.zeros((2, size, size, 3), np.float32))
    assert verts.shape == (2, 90, 3) and cam.shape == (2, 3)


def test_factory_refuses_other_joint_counts(monkeypatch):
    monkeypatch.setattr(multihmr, "create_multihmr", functools.partial(
        multihmr.create_multihmr, **widths(TINY)))
    with pytest.raises(ValueError, match="55"):
        serving.hmr_smpl_step(arch="multihmr_896_l", n_joints=24,
                              device="cpu")
    with pytest.raises(ValueError, match="56"):
        serving.hmr_smpl_step(arch="multihmr_896_l", image_size=64,
                              device="cpu")


def test_spans_and_counters_per_step(made):
    """Under a profiler session one step records ``multihmr.backbone`` and
    ``multihmr.head`` under ``step``, one ``multihmr.attention`` and one
    ``multihmr.mlp`` a block under the backbone, and answers N * P
    persons."""
    step = step_of(TINY, made)
    x = images(TINY, n=2).numpy()
    plain = step(x)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            traced = step(x)
        records = profiling.spans()
    finally:
        profiling.clear()
    verts, transl = traced
    assert verts.shape[:2] == transl.shape[:2] == (2, TINY["persons"])
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    root = records[0]
    assert root["name"] == "step" and root["parent"] is None
    names = [r["name"] for r in records if r["parent"] == root["id"]]
    assert names[:3] == ["step.h2d", "multihmr.backbone", "multihmr.head"]
    backbone = next(r for r in records if r["name"] == "multihmr.backbone")
    inner = [r["name"] for r in records if r["parent"] == backbone["id"]]
    assert inner == ["multihmr.attention", "multihmr.mlp"] * TINY["depth"]


def test_published_parameter_count():
    assert multihmr_vitl.parameter_count(PUBLISHED) == \
        PUBLISHED["encoder_parameters"] == 304_367_616


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the published widths run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_published_step_answers_and_launches(cuda):
    """``hmr_smpl_step(arch="multihmr_896_l")`` at the published widths on
    two 896^2 frames from host memory: (2, 8, 10475, 3) vertices and (2, 8,
    3) translations, finite; 48 ``add_layernorm`` launches, one
    ``fused_lbs``; the four kinds of span."""
    step = serving.hmr_smpl_step(arch="multihmr_896_l", device=cuda)
    x = images(PUBLISHED, n=2).numpy()
    step(x)
    torch.cuda.synchronize()
    native.reset_launches()
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            verts, transl = step(x)
        records = profiling.spans()
    finally:
        profiling.clear()
    assert verts.shape == (2, 8, 10475, 3) and transl.shape == (2, 8, 3)
    assert bool(torch.isfinite(verts).all() and torch.isfinite(transl).all())
    assert native.LAUNCHES["add_layernorm"] == 48
    assert native.LAUNCHES["fused_lbs"] == 1
    names = [r["name"] for r in records]
    for name, n in (("multihmr.backbone", 1), ("multihmr.attention", 24),
                    ("multihmr.mlp", 24), ("multihmr.head", 1)):
        assert names.count(name) == n
