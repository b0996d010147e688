"""tpubody_torch.models.hmr against the Flax HMR of tpubody.models.hmr, in
fp32 on the CPU at 64^2 (both are fully convolutional).

The Flax variables come from tpubody.utils.flaxtools.shape_init, with the
BatchNorm scale/bias and running statistics perturbed by seeded numpy
noise (var in [0.5, 1.5]) so that a mean/var or scale/bias swap in the
converter fails.  Tolerance: relative 1e-4 of the largest output (fp32
convolutions in another summation order through 16 or 4 blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.models import hmr as jhmr
from tpubody.utils.flaxtools import shape_init
from tpubody_torch.models import hmr as thmr

torch.set_num_threads(1)

REL = 1e-4


def _perturb(variables, seed=0):
    """numpy copy of a Flax tree with BN affine/statistics perturbed."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1]).strip(".[]'\"")
        x = np.array(x, np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.normal(size=(2, 64, 64, 3)).astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_small_resnet_matches_flax(images):
    model = jhmr.ResNet50(dtype=jnp.float32, stage_sizes=(1, 1, 1, 1))
    variables = _perturb(shape_init(model, jnp.zeros((1, 64, 64, 3))))
    want = np.asarray(model.apply(variables, jnp.asarray(images)))
    net = thmr.ResNet50(stage_sizes=(1, 1, 1, 1))
    net.load_state_dict(thmr.from_flax_variables(variables))
    with torch.no_grad():
        got = net.eval()(torch.as_tensor(images)).numpy()
    assert got.shape == (2, 2048)
    assert _rel(got, want) < REL


@pytest.fixture(scope="module")
def full_pair():
    model, variables = jhmr.create_hmr(dtype=jnp.float32, image_size=64,
                                       init="shape")
    variables = _perturb(variables, seed=1)
    port = thmr.HMR(jhmr.default_mean_params())
    port.load_state_dict(thmr.from_flax_variables(variables))
    port = thmr.to_compute(port, torch.float32, torch.device("cpu"))
    return model, variables, port


def test_full_hmr_matches_flax(full_pair, images):
    model, variables, port = full_pair
    want = model.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.as_tensor(images))
    for name in ("pose6d", "shape", "cam", "rotmats"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        assert _rel(g, w) < REL, (name, _rel(g, w))


def test_converter_round_trip():
    """reference torch state_dict -> tpubody convert_torch_state_dict ->
    from_flax_variables gives back the same tensors."""
    port = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=3)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.as_tensor(rng.normal(size=n)))
                m.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, n)))
                m.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.as_tensor(rng.normal(size=n)))
    sd = port.state_dict()
    reference = {k[len("backbone."):] if k.startswith("backbone.") else k:
                 v.numpy() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked")}
    flax_vars = jhmr.convert_torch_state_dict(reference,
                                              jhmr.default_mean_params())
    back = thmr.from_flax_variables(flax_vars)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k

    fresh = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=4)
    thmr.load_reference_state_dict(fresh, reference)
    for k, v in fresh.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_ief_starts_from_mean_params(images):
    port = thmr.create_hmr(dtype=torch.float32, device="cpu",
                           stage_sizes=(1, 1, 1, 1))
    with torch.no_grad():
        for head in ("decpose", "decshape", "deccam"):
            getattr(port, head).weight.zero_()
            getattr(port, head).bias.zero_()
        out = port(torch.as_tensor(images))
    mean = thmr.default_mean_params()
    np.testing.assert_allclose(out.pose6d[0].numpy(), mean[:144], atol=1e-6)
    np.testing.assert_allclose(out.shape[0].numpy(), mean[144:154], atol=1e-6)
    np.testing.assert_allclose(out.cam[0].numpy(), mean[154:], atol=1e-6)


def test_bf16_compute_dtype_layout(images):
    port = thmr.create_hmr(dtype=torch.bfloat16, device="cpu",
                           stage_sizes=(1, 1, 1, 1))
    assert port.backbone.conv1.weight.dtype == torch.bfloat16
    assert port.backbone.conv1.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert port.backbone.bn1.running_var.dtype == torch.float32
    assert port.fc1.weight.dtype == torch.bfloat16
    assert port.decpose.weight.dtype == torch.float32
    with torch.no_grad():
        out = port(torch.as_tensor(images))
    assert out.rotmats.dtype == torch.float32
    assert out.rotmats.shape == (2, 24, 3, 3) and out.cam.shape == (2, 3)
    R = out.rotmats.reshape(-1, 3, 3).numpy()
    np.testing.assert_allclose(R @ np.transpose(R, (0, 2, 1)),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-4)


def test_seeded_init_is_deterministic():
    a = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=7,
                        stage_sizes=(1, 1, 1, 1))
    b = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=7,
                        stage_sizes=(1, 1, 1, 1))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


def test_mean_params_match_tpubody(tmp_path):
    np.testing.assert_array_equal(thmr.default_mean_params(),
                                  jhmr.default_mean_params())
    path = str(tmp_path / "mean.npz")
    rng = np.random.default_rng(0)
    np.savez(path, pose=rng.normal(size=144), shape=rng.normal(size=10),
             cam=rng.normal(size=3))
    np.testing.assert_array_equal(thmr.load_mean_params(path),
                                  jhmr.load_mean_params(path))


def test_s2d_stem_equals_conv7(images):
    """Same state dict, either stem: the same outputs in fp32 (the bar of
    tests/test_hmr.py: 1e-4), on the backbone features and on the whole
    model."""
    a = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=5,
                        stage_sizes=(1, 1, 1, 1))
    b = thmr.create_hmr(dtype=torch.float32, device="cpu", seed=6,
                        stage_sizes=(1, 1, 1, 1), stem="s2d")
    assert set(a.state_dict()) == set(b.state_dict())
    assert tuple(b.backbone.conv1.weight.shape) == (64, 3, 7, 7)
    b.load_state_dict(a.state_dict())
    x = torch.as_tensor(images)
    with torch.no_grad():
        sa, sb = a.backbone.stem(x), b.backbone.stem(x)
        oa, ob = a(x), b(x)
    assert tuple(sb.shape) == (2, 64, 16, 16)
    assert (sa - sb).abs().max() < 1e-4
    for name in ("pose6d", "shape", "cam", "rotmats"):
        assert (getattr(oa, name) - getattr(ob, name)).abs().max() < 1e-4, name


def test_s2d_stem_matches_flax(images):
    """tpubody's ResNet50(stem="s2d") and the port's on one Flax tree, and
    the fall-back to the direct convolution for an odd input size."""
    model = jhmr.ResNet50(dtype=jnp.float32, stage_sizes=(1, 1, 1, 1),
                          stem="s2d")
    variables = _perturb(shape_init(model, jnp.zeros((1, 64, 64, 3))), seed=2)
    net = thmr.ResNet50(stage_sizes=(1, 1, 1, 1), stem="s2d")
    net.load_state_dict(thmr.from_flax_variables(variables))
    net.eval()
    for x in (images, images[:, :63, :61]):
        want = np.asarray(model.apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = net(torch.as_tensor(np.ascontiguousarray(x))).numpy()
        assert got.shape == (2, 2048)
        assert _rel(got, want) < REL
    # the odd size went through conv1 as it stands
    called = []
    net.conv1.register_forward_hook(lambda *a: called.append(1))
    with torch.no_grad():
        net(torch.as_tensor(images))
        assert not called
        net(torch.as_tensor(np.ascontiguousarray(images[:, :63])))
    assert called


def test_bench_fused_stage_chain_on_cpu():
    """The chain, its fused weights and the plain version behind
    tpubody_torch.bench.fused_stage, at tiny widths (the timed part needs
    the card)."""
    from tpubody_torch import bench
    from tpubody_torch.models import fused_resnet

    chain, fused, (H, W, c_in) = bench.build_stage_chain(
        1, shape=((0, 1, 2), 4, 9, 8))
    assert (H, W, c_in) == (9, 9, 8) and len(chain) == 3
    assert fused.n_rest == 2 and fused.Ad is not None
    assert chain[1].downsample is None
    one = bench.build_stage_chain(1, blocks=1, shape=((0, 1, 2), 4, 9, 8))[1]
    assert one.n_rest == 0 and torch.equal(one.A1_0, fused.A1_0)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, H, W, c_in)).astype(np.float32))
    with torch.no_grad():
        ref = chain(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = fused_resnet.run_stage(x, fused).float()
    assert (got - ref).abs().max() / ref.abs().max() < 2e-2
    work = bench.stage_work(fused, 2, H, W)
    # 2 * (8*4 + 36*4 + 4*16 + 8*16) + 2 * 2 * (16*4 + 36*4 + 4*16)
    assert work["flop_per_pixel"] == 736 + 2 * 544
    full = bench.stage_work(bench.build_stage_chain(2)[1], 512, 28, 28)
    assert full["flop_per_pixel"] == 1671168
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.fused_stage(1, device="cpu")
    with pytest.raises(ValueError):
        bench.fused_stage(1, what="xla", device="cpu")


def test_unported_options_raise():
    with pytest.raises(ValueError, match="stem"):
        thmr.create_hmr(stem="s4d", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thmr.create_hmr()          # entry points default to the card
