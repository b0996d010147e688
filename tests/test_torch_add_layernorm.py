"""The encoder's residual add + LayerNorm + cast
(``tpubody_torch.models.hmr2.add_layernorm``, ``csrc/add_layernorm.cu`` on
the card) against its plain version, ``add_layernorm_reference``, and the
restructured ``ViTH`` against a block-by-block eager run of its modules.

CPU bars: bit-equal.  The CPU runs the plain version, which is the eager
chain ``Block.forward`` ran before the kernel (``x + branch``, the
LayerNorm module, the cast ``_linear`` made), so tier-1's HMR 2.0 results
are those of that chain.

Card bars, the kernel against the plain version on the card: the new
stream ``x + branch`` bit-equal (one float32 add, the same on both); the
normalised output of another float32 summation order, so float32 output
within 2e-6 of its largest magnitude, and bf16 output within one bf16 ulp
of the larger of the two values, or within twice the float32 bar where
that is more (near zero an ulp is smaller than the float32 difference),
and unequal on under 0.1% of elements.  No JAX in this file: the card
tests run on the card as it is.
"""
import pytest
import torch
import torch.nn.functional as F

from tpubody_torch import native
from tpubody_torch.models import hmr2

torch.set_num_threads(2)

EPS = hmr2.ENCODER_EPS
DTYPES = (torch.bfloat16, torch.float32)
NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32"}
F32_BAR = 2e-6


def inputs(M, D, branch_dtype, device, seed=0):
    """A residual stream with a mean and scale of its own on every row, a
    branch and a LayerNorm with weights and biases away from (1, 0)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = (randn(M, D) * (0.5 + 3.5 * torch.rand(M, 1, generator=g,
                                                device=device))
         + 4 * torch.rand(M, 1, generator=g, device=device) - 2)
    branch = (0.5 * randn(M, D)).to(branch_dtype)
    norm = torch.nn.LayerNorm(D, eps=EPS, device=device)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * randn(D))
        norm.bias.copy_(0.1 * randn(D))
    return x, branch, norm


def eager_chain(x, branch, norm, out_dtype):
    """What ``Block.forward`` ran before the kernel."""
    x = x + branch
    return x, F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias,
                           norm.eps).to(out_dtype)


def eager_vith(vit, images):
    """``ViTH.forward`` block by block as the eager chain: each LayerNorm
    in float32, each Linear's ``_linear`` cast, each add on its own."""
    lo = (vit.image_size - vit.crop_width) // 2
    x = vit.patch_embed(images[:, :, lo:lo + vit.crop_width])
    x = x + (vit.pos_embed[:, 1:] + vit.pos_embed[:, :1])
    for block in vit.blocks:
        x = x + block.attn(block.norm1(x))
        x = x + block.mlp(block.norm2(x))
    return vit.last_norm(x)


def tiny_hmr2(depth, dtype, device="cpu", **widths):
    """HMR 2.0 at ``depth`` blocks, LayerNorms away from (1, 0)."""
    model = hmr2.create_hmr2(dtype=dtype, device=device, seed=7, depth=depth,
                             dec_depth=1, **widths)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for m in model.backbone.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return model


TINY = {"image_size": 64, "crop_width": 48, "patch_size": 8, "dim": 64,
        "heads": 4, "mlp_dim": 256, "dec_dim": 32, "dec_heads": 2,
        "dec_dim_head": 16, "dec_mlp_dim": 32}


# -- the CPU: the plain version -------------------------------------------
@pytest.mark.parametrize("D", (8, 64, 1280))
@pytest.mark.parametrize("out_dtype", DTYPES, ids=NAMES.get)
@pytest.mark.parametrize("branch_dtype", DTYPES, ids=NAMES.get)
def test_plain_version_equals_the_eager_chain(branch_dtype, out_dtype, D):
    x, branch, norm = inputs(6, D, branch_dtype, "cpu")
    x, branch = x.view(2, 3, D), branch.view(2, 3, D)
    want_x, want_h = eager_chain(x, branch, norm, out_dtype)
    with torch.no_grad():
        got_x, got_h = hmr2.add_layernorm(x, branch, norm, out_dtype)
        none, h = hmr2.add_layernorm(x, branch, norm, out_dtype,
                                     keep_x=False)
    assert got_x.dtype == torch.float32 and got_h.dtype == out_dtype
    assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)
    assert none is None and torch.equal(h, want_h)


def layerscale(D, device, seed=1):
    """A LayerScale gamma (D,) float32, away from 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    return 0.1 + 0.4 * torch.rand(D, generator=g, device=device)


@pytest.mark.parametrize("out_dtype", DTYPES, ids=NAMES.get)
@pytest.mark.parametrize("branch_dtype", DTYPES, ids=NAMES.get)
def test_plain_version_with_a_scale_equals_the_eager_chain(branch_dtype,
                                                           out_dtype):
    """With LayerScale the new stream is ``x + gamma * branch``, the
    product and the add each rounded in float32, as the eager chain."""
    x, branch, norm = inputs(6, 64, branch_dtype, "cpu")
    gamma = layerscale(64, "cpu")
    want_x = x + gamma * branch
    want_h = F.layer_norm(want_x, (64,), norm.weight, norm.bias,
                          norm.eps).to(out_dtype)
    with torch.no_grad():
        got_x, got_h = hmr2.add_layernorm(x, branch, norm, out_dtype,
                                          scale=gamma)
    assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)
    assert not torch.equal(got_x, x + branch)


@pytest.mark.parametrize("dtype", DTYPES, ids=NAMES.get)
@pytest.mark.parametrize("depth", (1, 3))
def test_vith_equals_the_block_by_block_eager_run(depth, dtype):
    """The stream and its normalised view carried from block to block give
    the eager chain's float32 ``last_norm`` output bit for bit, and the
    CPU launches no kernel."""
    model = tiny_hmr2(depth, dtype, **TINY)
    images = torch.randn((3, 64, 64, 3), generator=torch.Generator()
                         .manual_seed(9))
    before = native.LAUNCHES["add_layernorm"]
    with torch.no_grad():
        got = model.backbone(images)
        want = eager_vith(model.backbone, images)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == (3, 48, 64)
    assert torch.equal(got, want)
    assert native.LAUNCHES["add_layernorm"] == before


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the add_layernorm kernel has no CPU "
                    "mode; chip_smoke.py phase 28 runs it on the card")
    return torch.device("cuda")


def bf16_ulp(t):
    """One bf16 ulp at each |t| (float32): 2^(exponent - 8)."""
    _, e = torch.frexp(t)
    return torch.ldexp(torch.ones_like(t), e - 8)


def hold(got, want):
    """The kernel's normalised output against the plain version's, both in
    the output dtype, under the bars of the module docstring."""
    scale = float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert float(diff.max()) <= F32_BAR * scale
        return
    larger = torch.maximum(got.float().abs(), want.float().abs())
    bar = bf16_ulp(larger).clamp(min=2 * F32_BAR * scale)
    assert bool((diff <= bar).all())
    assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("branch_dtype", DTYPES, ids=NAMES.get)
@pytest.mark.parametrize("out_dtype", DTYPES, ids=NAMES.get)
@pytest.mark.parametrize("M", (98_304, 1_001))
@pytest.mark.parametrize("D", (768, 1024, 1280, 8, 1000, 2048))
def test_cuda_kernel_matches_the_plain_version(cuda, D, M, out_dtype,
                                               branch_dtype):
    """The ViT widths, the narrowest and widest rows it takes and one
    whose 125 chunks leave lanes short; the main path's 98,304 tokens and
    1,001 (not a multiple of the 8 rows of a block)."""
    x, branch, norm = inputs(M, D, branch_dtype, cuda, seed=D + M)
    before = native.LAUNCHES["add_layernorm"]
    with torch.no_grad():
        got_x, got_h = hmr2.add_layernorm(x, branch, norm, out_dtype)
        none, h = hmr2.add_layernorm(x, branch, norm, out_dtype,
                                     keep_x=False)
        want_x, want_h = hmr2.add_layernorm_reference(x, branch, norm,
                                                      out_dtype)
    torch.cuda.synchronize()
    assert native.LAUNCHES["add_layernorm"] == before + 2
    assert got_h.dtype == out_dtype and none is None
    assert torch.equal(got_x, want_x)
    assert torch.equal(h, got_h)
    hold(got_h, want_h)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", (False, True), ids=("plain", "scaled"))
@pytest.mark.parametrize("out_dtype", DTYPES, ids=NAMES.get)
def test_cuda_kernel_at_multihmr_shape(cuda, out_dtype, scaled):
    """Multi-HMR's encoder: 64 frames of 4,097 tokens of 1,024, the bf16
    branch with LayerScale and without.  The new stream bit-equal to the
    plain version's, the normalised output under the bars above; a scale
    of ones gives the unscaled kernel's bits."""
    M, D = 64 * 4097, 1024
    x, branch, norm = inputs(M, D, torch.bfloat16, cuda, seed=7)
    gamma = layerscale(D, cuda) if scaled else None
    with torch.no_grad():
        got_x, got_h = hmr2.add_layernorm(x, branch, norm, out_dtype,
                                          scale=gamma)
        want_x, want_h = hmr2.add_layernorm_reference(x, branch, norm,
                                                      out_dtype, scale=gamma)
        ones_x, ones_h = hmr2.add_layernorm(
            x, branch, norm, out_dtype,
            scale=torch.ones(D, device=cuda) if not scaled else None)
    torch.cuda.synchronize()
    assert torch.equal(got_x, want_x)
    hold(got_h, want_h)
    if not scaled:
        assert torch.equal(ones_x, got_x) and torch.equal(ones_h, got_h)
    else:
        assert not torch.equal(ones_x, got_x)


@pytest.mark.cuda
def test_cuda_refuses_what_it_does_not_take(cuda):
    x, branch, norm = inputs(64, 1024, torch.bfloat16, cuda)
    bf16 = torch.bfloat16
    with torch.no_grad():
        for D in (1004, 2056, 4):
            a, b, n = inputs(16, D, bf16, cuda)
            with pytest.raises(RuntimeError, match="multiple of 8"):
                hmr2.add_layernorm(a, b, n, bf16)
        with pytest.raises(RuntimeError, match="contiguous"):
            hmr2.add_layernorm(x.t().contiguous().t(), branch, norm, bf16)
        with pytest.raises(RuntimeError, match="contiguous"):
            hmr2.add_layernorm(x, branch.t().contiguous().t(), norm, bf16)
        flat = torch.empty(64 * 1024 + 1, device=cuda)
        shifted = flat[1:].view(64, 1024).copy_(x)
        with pytest.raises(RuntimeError, match="aligned"):
            hmr2.add_layernorm(shifted, branch, norm, bf16)
        with pytest.raises(RuntimeError, match="expected"):
            hmr2.add_layernorm(x, branch[:32], norm, bf16)
        with pytest.raises(RuntimeError, match="bf16 or float32 output"):
            hmr2.add_layernorm(x, branch, norm, torch.float16)
        for gamma in (torch.ones(1000, device=cuda),
                      torch.ones(1024, device=cuda).half()):
            with pytest.raises(RuntimeError, match="scale"):
                hmr2.add_layernorm(x, branch, norm, bf16, scale=gamma)
        for args in ((x, branch.half(), norm, bf16),
                     (x.double(), branch, norm, bf16)):
            with pytest.raises(RuntimeError, match="expected one of"):
                hmr2.add_layernorm(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        hmr2.add_layernorm(x, branch, norm, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=NAMES.get)
def test_cuda_vith_launches_two_a_block(cuda, dtype, monkeypatch):
    """One forward of the published-width encoder at depth 4 launches 8
    kernels and agrees with the same model through the plain version on
    the card: float32 within 1e-5 of the largest token magnitude, bf16
    within 1e-2 (a bf16 ulp flipped on some LayerNorm outputs feeds every
    later product)."""
    model = tiny_hmr2(4, dtype, device=cuda)
    images = torch.randn((2, 256, 256, 3), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(9))
    before = native.LAUNCHES["add_layernorm"]
    with torch.no_grad():
        got = model.backbone(images)
        assert native.LAUNCHES["add_layernorm"] == before + 8
        monkeypatch.setattr(hmr2, "add_layernorm",
                            hmr2.add_layernorm_reference)
        want = model.backbone(images)
    assert native.LAUNCHES["add_layernorm"] == before + 8
    assert got.shape == want.shape == (2, 192, 1280)
    assert got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert err < (1e-5 if dtype == torch.float32 else 1e-2)
