"""tpubody_torch.models.fused_resnet against tpubody.models.pallas_resnet,
whose Pallas kernel ``_stage_kernel`` runs in interpret mode on the CPU, on
the shapes of tests/test_pallas_resnet.py (4 features, 8-12 pixel images,
1-3 blocks).  Inputs and weights are seeded numpy.

Tolerances:
  * fuse_stage: the port's folded weights equal tpubody's bit for bit (both
    fold in float64 from the same float32 values and round the same way);
  * the plain version of the kernel vs the Pallas kernel in interpret mode:
    both round h1, h2 and y to bf16 at the same places and differ only in
    the order of their f32 sums, so an element can land on the other side
    of a bf16 rounding boundary: within 2 bf16 ulps of the largest output
    (2^-7 of it), and at least 99% of the elements equal bit for bit;
  * both within 2e-2 (relative to the largest output) of the f32 Flax
    chain, the bar of tests/test_pallas_resnet.py.
The CUDA kernel runs only on a GPU: its tests skip here and run on the
card with
``python -m pytest --noconftest -p no:cacheprovider -k cuda tests/test_torch_fused_resnet.py``
(the one that holds the kernel to tpubody needs jax and flax beside the
card and skips, saying so, where they are missing).
"""
import numpy as np
import pytest
import torch

from tpubody_torch import native
from tpubody_torch.models import fused_resnet as FR
from tpubody_torch.models import hmr as thmr

torch.set_num_threads(1)

ULPS2 = 2.0 ** -7      # 2 bf16 ulps of the largest output
EQUAL_SHARE = 0.99
FLAX_REL = 2e-2

# name: (stage, n blocks, (B, H, W, C_in), input seed, weight seed, zero input)
CASES = {
    "downsample": (1, 3, (2, 12, 12, 8), 1, 0, False),
    "identity": (2, 2, (2, 8, 8, 16), 2, 0, False),
    "single": (1, 1, (1, 10, 10, 8), 3, 0, False),
    "ragged_11x19": (1, 2, (2, 11, 19, 8), 4, 0, False),
    "zero_input": (1, 2, (1, 9, 9, 8), 0, 5, True),
}
FEATS = 4
# the CUDA kernel alone also runs a 28x28 image (stage 2's size, one band of
# 256 padded positions spans image rows) and a batch whose bands straddle
# images
CUDA_CASES = {**CASES, "image_28x28": (2, 2, (3, 28, 28, 16), 6, 1, False)}


def jax_side():
    """tpubody's modules (they need jax and flax), imported on first use."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tpubody.models import pallas_resnet as PR
    from tpubody.models.hmr import Bottleneck

    class Blocks(fnn.Module):
        stage: int
        n: int
        feats: int

        @fnn.compact
        def __call__(self, x):
            for j in range(self.n):
                x = Bottleneck(self.feats, strides=1, dtype=jnp.float32,
                               name=f"layer{self.stage}_{j}")(x, False)
            return x

    return jax, jnp, PR, Blocks


def random_vars(mod, example, seed, lo=0.05, hi=0.4):
    """Flax variables with every leaf (weights and batch statistics) drawn
    from a seeded numpy generator, as tests/test_pallas_resnet.py does."""
    jax, jnp, _, _ = jax_side()
    rng = np.random.default_rng(seed)
    vs = mod.init(jax.random.PRNGKey(0), example)
    leaves, treedef = jax.tree_util.tree_flatten(vs)
    leaves = [np.asarray(rng.uniform(lo, hi, np.shape(l)), np.float32)
              for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def port_blocks(vs, stage, n, c_in):
    """The port's Bottleneck chain loaded from a Flax tree through
    from_flax_variables."""
    blocks, feats_in = [], c_in
    for _ in range(n):
        blocks.append(thmr.Bottleneck(feats_in, FEATS, 1))
        feats_in = FEATS * 4
    sd = thmr.from_flax_variables({
        "params": {"conv1": {"kernel": np.zeros((7, 7, 3, 64), np.float32)},
                   "bn1": {"scale": np.ones(64), "bias": np.zeros(64)},
                   **vs["params"]},
        "batch_stats": {"bn1": {"mean": np.zeros(64), "var": np.ones(64)},
                        **vs["batch_stats"]}})
    chain = torch.nn.Sequential(*blocks)
    prefix = f"layer{stage}."
    chain.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                           if k.startswith(prefix)})
    return chain.eval()


def make_case(name):
    """-> (x numpy, Flax module, variables, tpubody FusedStage, port chain,
    port FusedStage)."""
    _, jnp, PR, Blocks = jax_side()
    stage, n, shape, xseed, wseed, zero = CASES[name]
    x = np.zeros(shape, np.float32) if zero else \
        np.random.default_rng(xseed).normal(size=shape).astype(np.float32)
    mod = Blocks(stage=stage, n=n, feats=FEATS)
    vs = random_vars(mod, jnp.zeros((1,) + shape[1:]), wseed)
    blocks = list(range(n))
    jfused = PR.fuse_stage(vs["params"], vs["batch_stats"], stage, blocks)
    chain = port_blocks(vs, stage, n, shape[-1])
    return x, mod, vs, jfused, chain, FR.fuse_stage(chain, blocks)


def bits(a):
    """bf16 array (jax or torch) -> uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.array(a).view(np.uint16)


def jax_fields(jfused):
    out = {}
    for name in FR.FIELDS:
        a = getattr(jfused, name)
        if a is None:
            out[name] = None
        elif name[0] == "A":
            out[name] = bits(a)
        else:
            out[name] = np.asarray(a, np.float32)
    return out


def assert_close_to_kernel_bar(got, want, what):
    """got, want: float32 arrays of bf16 values."""
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    share = float((got == want).mean())
    assert err <= ULPS2 * scale, (what, err, scale)
    assert share >= EQUAL_SHARE, (what, share)


@pytest.mark.parametrize("name", ["downsample", "identity", "single"])
def test_fuse_stage_equals_tpubody_bit_for_bit(name):
    _, _, _, jfused, _, fused = make_case(name)
    assert fused.n_rest == jfused.n_rest
    assert (fused.Ad is None) == (jfused.Ad is None) == (name == "identity")
    want = jax_fields(jfused)
    got = fused.as_reference_layout()
    for field in FR.FIELDS:
        if want[field] is None:
            assert got[field] is None
            continue
        assert tuple(got[field].shape) == want[field].shape, field
        if field[0] == "A":
            assert got[field].dtype == torch.bfloat16
            np.testing.assert_array_equal(bits(got[field]), want[field], field)
        else:
            assert got[field].dtype == torch.float32
            np.testing.assert_array_equal(got[field].numpy(), want[field],
                                          field)
    # the carried-across weights: numpy fields of tpubody's -> the port's
    for arrays in (want, {k: None if v is None else
                          (torch.from_numpy(v.view(np.int16))
                           .view(torch.bfloat16).float().numpy()
                           if k[0] == "A" else v) for k, v in want.items()}):
        back = FR.fused_stage_from_numpy(arrays, jfused.n_rest)
        for field in FR.FIELDS:
            a, b = getattr(back, field), got[field]
            assert (a is None and b is None) or torch.equal(a, b), field
        assert len(back.packed) == jfused.n_rest + 1


def test_fuse_stage_rejects_downsample_after_first():
    chain = torch.nn.Sequential(thmr.Bottleneck(8, FEATS, 1),
                                thmr.Bottleneck(16, FEATS, 1))
    with pytest.raises(ValueError, match="first fused block"):
        FR.fuse_stage(chain, [1, 0])
    _, _, PR, Blocks = jax_side()
    import jax
    mod = Blocks(stage=1, n=2, feats=FEATS)
    vs = mod.init(jax.random.PRNGKey(0), np.zeros((1, 8, 8, 8), np.float32))
    with pytest.raises(ValueError):
        PR.fuse_stage(vs["params"], vs["batch_stats"], 1, [1, 0])
    with pytest.raises(ValueError, match="stride-1"):
        FR.fuse_stage([thmr.Bottleneck(16, FEATS, 2)], [0])


def unswizzle(flat, n_rows, k_cols):
    """The kernel's flat B tiles -> the (n_rows, k_cols) matrix, read by the
    rule of a wgmma descriptor with 128-byte swizzle: chunks of up to 128
    rows, K slices of 64 (128-byte rows), and in row r the 16-byte chunk
    stored at position p holds K columns 8 (p ^ (r % 8)) .. + 8."""
    out = torch.full((n_rows, k_cols), float("nan"), dtype=torch.bfloat16)
    pos = 0
    for n0 in range(0, n_rows, 128):
        rows = min(128, n_rows - n0)
        for k0 in range(0, k_cols, 64):
            tile = flat[pos:pos + rows * 64].reshape(rows, 8, 8)
            pos += rows * 64
            for r in range(rows):
                for p in range(8):
                    c = p ^ (r % 8)
                    out[n0 + r, k0 + 8 * c:k0 + 8 * c + 8] = tile[r, p]
    assert pos == flat.numel()
    return out


def test_packed_layout_pads_the_weights_with_zeros():
    _, _, _, _, _, fused = make_case("single")
    blk = fused.packed[0]
    assert (blk["c_in"], blk["c_mid"], blk["c_out"]) == (8, 4, 16)
    assert tuple(blk["w1"].shape) == (64 * 64,)
    assert tuple(blk["w2"].shape) == (9 * 64 * 64,)
    assert tuple(blk["w3"].shape) == (64 * 64,) == tuple(blk["wd"].shape)
    w1 = unswizzle(blk["w1"], 64, 64)
    assert torch.equal(w1[:4, :8], fused.A1_0)
    assert not w1[4:].any() and not w1[:, 8:].any()
    for tap in range(9):
        w2 = unswizzle(blk["w2"][tap * 4096:(tap + 1) * 4096], 64, 64)
        assert torch.equal(w2[:4, :4], fused.A2_0[:, tap * 4:(tap + 1) * 4])
        assert not w2[4:].any() and not w2[:, 4:].any()
    assert not blk["b1"][4:].any() and tuple(blk["b1"].shape) == (64,)
    assert torch.equal(blk["b3"][:16], fused.b3_0[:, 0])
    assert not blk["b3"][16:].any()


@pytest.mark.parametrize("c_in,feats,down", [(8, 4, True), (256, 64, False),
                                             (64, 32, True), (24, 40, True),
                                             (1024, 256, False),
                                             (2048, 512, False)])
def test_unswizzled_tiles_give_back_the_padded_matrices(c_in, feats, down):
    """Un-swizzling the packed tiles gives back the zero-padded (C_mid,
    C_in), (9, C_mid, C_mid) and (C_out, C_mid) / (C_out, C_in) matrices
    bit for bit, at widths of one chunk, of two chunks of 128 rows, of a
    chunk of 64 rows after one of 128, and at ResNet-50's stage 3 and 4
    widths (C_mid 256 and 512: the wide route reads w1 and w2 in column
    chunks of 128 rows, chunk nc at offset nc * 128 * K)."""
    rng = np.random.default_rng(c_in + feats)
    blk_mod = thmr.Bottleneck(c_in, feats, 1)
    if not down:
        blk_mod.downsample = None
    chain = torch.nn.Sequential(blk_mod).eval()
    with torch.no_grad():
        for t in list(chain.parameters()) + [b for b in chain.buffers()
                                             if b.dtype.is_floating_point]:
            t.copy_(torch.as_tensor(rng.uniform(0.05, 0.4, tuple(t.shape))))
    fused = FR.fuse_stage(chain, [0])
    blk = fused.packed[0]
    pm, pi, po = (-(-c // 64) * 64 for c in (feats, c_in, 4 * feats))

    def padded(a, shape):
        out = torch.zeros(shape, dtype=torch.bfloat16)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    assert torch.equal(unswizzle(blk["w1"], pm, pi),
                       padded(fused.A1_0, (pm, pi)))
    A2 = fused.A2_0.reshape(feats, 9, feats)
    for tap in range(9):
        got = unswizzle(blk["w2"][tap * pm * pm:(tap + 1) * pm * pm], pm, pm)
        assert torch.equal(got, padded(A2[:, tap], (pm, pm))), tap
    assert torch.equal(unswizzle(blk["w3"], po, pm),
                       padded(fused.A3_0, (po, pm)))
    assert (blk["wd"] is None) == (not down)
    if down:
        assert torch.equal(unswizzle(blk["wd"], po, pi),
                           padded(fused.Ad, (po, pi)))


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_pallas_kernel(name):
    _, jnp, PR, _ = jax_side()
    x, mod, vs, jfused, chain, fused = make_case(name)
    want = np.asarray(PR.run_stage(jnp.asarray(x), jfused, interpret=True),
                      np.float32)
    got = FR.run_stage_reference(torch.from_numpy(x), fused)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert_close_to_kernel_bar(got.float().numpy(), want, name)
    flax = np.asarray(mod.apply(vs, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        port = chain(torch.from_numpy(x).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    scale = np.abs(flax).max()
    assert np.abs(port - flax).max() / scale < 1e-5   # the f32 chains agree
    for y in (got.float().numpy(), want):
        assert np.abs(y - flax).max() / scale < FLAX_REL
    if name == "zero_input":
        # the response to zeros is the biases': not zero, and the same at
        # every pixel away from the border
        g = got.float()
        assert g.abs().min() > 0 and torch.equal(g[0, 3, 3], g[0, 5, 4])


@pytest.mark.parametrize("c,to", [(20, 24), (12, 16), (16, 16), (3, 8)])
def test_pad_channels_zero_fills_the_channel_axis(c, to):
    """run_stage pads x's channels to the kernel's multiple of 8 with
    zeros (and slices y back): the values stay, the new channels are 0."""
    x = torch.as_tensor(np.random.default_rng(c).normal(
        size=(2, 3, 5, c)).astype(np.float32)).to(torch.bfloat16)
    y = FR.pad_channels(x, to)
    assert tuple(y.shape) == (2, 3, 5, to) and y.is_contiguous()
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[..., :c], x) and not y[..., c:].any()
    assert FR._round8(c) == to
    with pytest.raises(ValueError, match="cannot pad"):
        FR.pad_channels(x, c - 1)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, _, _, _, _, fused = make_case("identity")
    before = native.LAUNCHES["fused_stage"]
    y = FR.run_stage(torch.from_numpy(x), fused)
    assert native.LAUNCHES["fused_stage"] == before
    assert torch.equal(y, FR.run_stage_reference(torch.from_numpy(x), fused))
    assert tuple(y.shape) == (2, 8, 8, 16)
    with pytest.raises(ValueError, match="channels"):
        FR.run_stage(torch.zeros(1, 8, 8, 8), fused)
    with pytest.raises(ValueError, match=r"\(B, H, W, C_in\)"):
        FR.run_stage(torch.zeros(8, 8, 16), fused)


def test_odd_c_mid_is_accepted():
    """tpubody refuses an odd C_mid (its packed rolls); the port's kernel
    pads the weights instead, and the plain version takes any width."""
    rng = np.random.default_rng(7)
    chain = torch.nn.Sequential(thmr.Bottleneck(12, 3, 1)).eval()
    with torch.no_grad():
        for p in chain.parameters():
            p.copy_(torch.as_tensor(rng.uniform(0.05, 0.4, tuple(p.shape))))
    fused = FR.fuse_stage(chain, [0])
    assert fused.Ad is None and tuple(fused.A2_0.shape) == (3, 27)
    x = torch.as_tensor(rng.normal(size=(1, 6, 7, 12)).astype(np.float32))
    y = FR.run_stage(x, fused).float()
    with torch.no_grad():
        want = chain(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (y - want).abs().max() / want.abs().max() < FLAX_REL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused_stage kernel has no CPU "
                    "mode; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


def cuda_case(name, device):
    """-> (x numpy, FusedStage on the card, run_stage's output there); checks
    that the kernel launched once a block."""
    stage, n, shape, xseed, wseed, zero = CUDA_CASES[name]
    rng = np.random.default_rng(wseed)
    blocks, c_in = [], shape[-1]
    for _ in range(n):
        blocks.append(thmr.Bottleneck(c_in, FEATS, 1))
        c_in = FEATS * 4
    chain = torch.nn.Sequential(*blocks).eval()
    with torch.no_grad():
        for t in list(chain.parameters()) + [b for b in chain.buffers()
                                             if b.dtype.is_floating_point]:
            t.copy_(torch.as_tensor(rng.uniform(0.05, 0.4, tuple(t.shape))))
    fused = FR.fuse_stage(chain, list(range(n))).to(device)
    x = np.zeros(shape, np.float32) if zero else \
        np.random.default_rng(xseed).normal(size=shape).astype(np.float32)
    before = native.LAUNCHES["fused_stage"]
    y = FR.run_stage(torch.as_tensor(x, device=device), fused)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_stage"] == before + n
    return x, fused, y


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_kernel_matches_plain(cuda, name):
    x, fused, y = cuda_case(name, cuda)
    plain = FR.run_stage_reference(torch.as_tensor(x, device=cuda), fused)
    assert_close_to_kernel_bar(y.float().cpu().numpy(),
                               plain.float().cpu().numpy(), name)


# name: (n blocks, (B, H, W, C_in), C_mid, C_out, input seed, weight
# seed): the widths the narrow kernel refused -- ResNet-50's stage 3 and 4
# tails at a small batch, and channel counts off a multiple of 8
WIDE_CASES = {
    "stage3_cmid256": (2, (2, 14, 14, 1024), 256, 1024, 1, 2),
    "stage4_cmid512": (2, (2, 7, 7, 2048), 512, 2048, 3, 4),
    "cmid256_downsample": (1, (2, 14, 14, 512), 256, 1024, 9, 10),
    "cmid256_56x56": (1, (1, 56, 56, 1024), 256, 1024, 11, 12),
    "ragged_20_10_20": (2, (2, 9, 11, 20), 10, 20, 5, 6),
    "downsample_12_to_20": (1, (1, 8, 8, 12), 5, 20, 7, 8),
}
# Kernel launches a bottleneck: one where a block's shared memory holds h1
# and h2 of a band (C_mid 256 at 14^2 without a downsample), two where h2
# goes through device memory (C_mid 512; C_mid 256 with a downsample or at
# 56^2).
WIDE_LAUNCHES = {"stage3_cmid256": 1, "stage4_cmid512": 2,
                 "cmid256_downsample": 2, "cmid256_56x56": 2,
                 "ragged_20_10_20": 1, "downsample_12_to_20": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_cuda_wide_and_ragged_widths_match_plain(cuda, name):
    """run_stage on the card at C_mid 256 and 512 (the wide route, in one
    launch a bottleneck or two) and at C_in, C_out off a multiple of 8 (x
    padded, y sliced): every block within the kernel's bar of the plain
    version (run_stage_reference)."""
    n, shape, c_mid, c_out, xseed, wseed = WIDE_CASES[name]
    rng = np.random.default_rng(wseed)
    blocks, c_in = [], shape[-1]
    for _ in range(n):
        blk = thmr.Bottleneck(c_in, c_mid, 1)
        if c_out != 4 * c_mid:          # other widths than 4 C_mid
            blk.conv3 = torch.nn.Conv2d(c_mid, c_out, 1, bias=False)
            blk.bn3 = torch.nn.BatchNorm2d(c_out)
            blk.downsample = None if c_in == c_out else torch.nn.Sequential(
                torch.nn.Conv2d(c_in, c_out, 1, bias=False),
                torch.nn.BatchNorm2d(c_out))
        blocks.append(blk)
        c_in = c_out
    chain = torch.nn.Sequential(*blocks).eval()
    with torch.no_grad():
        for t in list(chain.parameters()) + [b for b in chain.buffers()
                                             if b.dtype.is_floating_point]:
            t.copy_(torch.as_tensor(rng.uniform(0.02, 0.1, tuple(t.shape))))
    fused = FR.fuse_stage(chain, list(range(n))).to(cuda)
    x = torch.as_tensor(np.random.default_rng(xseed).normal(
        size=shape).astype(np.float32), device=cuda)
    per_block = WIDE_LAUNCHES[name]
    h = x.to(torch.bfloat16)
    for blk in fused.blocks():
        one = FR.FusedStage(*blk, *[getattr(fused, f)
                                    for f in FR.FIELDS[8:]], n_rest=0)
        before = native.LAUNCHES["fused_stage"]
        got = FR.run_stage(h, one)
        torch.cuda.synchronize()
        assert native.LAUNCHES["fused_stage"] == before + per_block
        h = FR.run_stage_reference(h, one)
        assert got.shape == h.shape and got.dtype == torch.bfloat16
        assert_close_to_kernel_bar(got.float().cpu().numpy(),
                                   h.float().cpu().numpy(), name)
    y = FR.run_stage(x, fused)
    assert tuple(y.shape) == shape[:3] + (c_out,) and y.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_tpubody(cuda, name):
    try:
        _, jnp, PR, _ = jax_side()
    except ImportError:
        pytest.skip("no jax or flax here: the CUDA kernel is not held to "
                    "tpubody's Pallas kernel")
    x, fused, y = cuda_case(name, cuda)
    arrays = {k: None if v is None else
              (bits(v.cpu()) if k[0] == "A" else v.cpu().numpy())
              for k, v in fused.as_reference_layout().items()}
    jfused = PR.FusedStage(**{
        k: None if v is None else
        (jnp.asarray(v.view(jnp.bfloat16)) if k[0] == "A" else jnp.asarray(v))
        for k, v in arrays.items()}, n_rest=fused.n_rest)
    want = np.asarray(PR.run_stage(jnp.asarray(x), jfused, interpret=True),
                      np.float32)
    assert_close_to_kernel_bar(y.float().cpu().numpy(), want, name)
