"""The keypoint decode for inference (``pose2d.soft_argmax_decode``,
``csrc/soft_argmax.cu`` on the card) against its plain version,
``pose2d.soft_argmax``, and ``SapiensPose.decode`` on it.

CPU: the wrapper is ``soft_argmax`` itself, bit for bit, and so is
Sapiens' decode; the kernel's arithmetic, written here in torch (pixel
slices of the kernel's blocks, each dealt to its row phases, each phase's
max and three sums, merged by rescaling with exp(m_i - m) in a fixed
order), agrees with ``soft_argmax`` within 1e-5 of the coordinate scale on
peaked, flat and Gaussian heatmaps.

Card: the kernel against the plain version within 1e-3 px for x and y and
1e-5 for the confidence: the sums of up to 49,152 terms a keypoint are
taken in another order.  The plain version runs in float64 there, so that
the bar reads the kernel's rounding and not the float32 eager chain's own.
No JAX in this file: the card tests run on the card as it is.
"""
import math

import pytest
import torch

from tpubody_torch import native
from tpubody_torch.models import pose2d, sapiens

torch.set_num_threads(2)

STRIDE = 4
EIGHT_PI = 2.0 * math.pi * 4.0
KEYPOINTS = (17, 133, 308)     # COCO, COCO-WholeBody, Goliath
KINDS = ("peak", "flat", "gaussian")
# 29 x 23 = 667 pixels: no slice count of the tests below divides it.
H, W = 29, 23


def heatmaps(kind, B, h, w, K, device="cpu", seed=0):
    """(B, h, w, K) float32 logits.  peak: one pixel a keypoint 80 above
    noise, so that the other slices' sums vanish beside its own; flat: all
    zero; gaussian: -d^2 / (2 sigma^2) about a random centre, sigma 1.5 to
    6 pixels, plus noise, so that the confidences spread over (0, 1]."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    noise = torch.randn((B, h, w, K), generator=g, device=device)
    if kind == "flat":
        return torch.zeros((B, h, w, K), device=device)
    if kind == "peak":
        at = (rand(B, K) * (h * w)).long()
        flat = noise.view(B, h * w, K)
        flat.scatter_add_(1, at.unsqueeze(1), torch.full((B, 1, K), 80.0,
                                                         device=device))
        return noise
    yy = torch.arange(h, device=device).view(1, h, 1, 1).float()
    xx = torch.arange(w, device=device).view(1, 1, w, 1).float()
    cy, cx = rand(B, 1, 1, K) * h, rand(B, 1, 1, K) * w
    sigma = 1.5 + 4.5 * rand(B, 1, 1, K)
    return (-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2)
            + 0.5 * noise)


def kernel_rows(K, vec):
    """The kernel's row phases a block: 512 threads over cols x rows, cols
    the (K / 4 or K) column groups up to 512 (``layout_of``)."""
    cols = min(K // 4 if vec else K, 512)
    return 512 // cols


def merge(parts):
    """(m, s, sx, sy) partials, each (B, K), merged in their order, each
    rescaled by exp(m_i - m)."""
    top = torch.stack([p[0] for p in parts]).amax(0)
    ref = torch.where(top == -math.inf, torch.zeros_like(top), top)
    s = sx = sy = torch.zeros_like(top)
    for m, ps, px, py in parts:
        a = torch.exp(m - ref)
        s, sx, sy = ps * a + s, px * a + sx, py * a + sy
    return top, s, sx, sy


def sliced_soft_argmax(logits, stride, slices, phases):
    """The kernel's arithmetic in torch, float32: frame rows cut into
    ``slices`` of ceil(P / slices) pixels, a slice's row p dealt to phase
    (p - p0) % ``phases``; each phase's max and three sums, the phases
    merged in order, then the slices."""
    B, h, w, K = logits.shape
    P = h * w
    flat = logits.reshape(B, P, K)
    p = torch.arange(P)
    xs, ys = (p % w).float().view(1, P, 1), (p // w).float().view(1, P, 1)
    per = -(-P // slices)
    merged = []
    for p0 in range(0, P, per):
        partial = []
        for r in range(min(phases, P - p0, per)):
            rows = torch.arange(p0 + r, min(P, p0 + per), phases)
            l = flat[:, rows]
            m = l.amax(1)
            e = torch.exp(l - m.unsqueeze(1))
            partial.append((m, e.sum(1), (e * xs[:, rows]).sum(1),
                            (e * ys[:, rows]).sum(1)))
        merged.append(merge(partial))
    _, s, sx, sy = merge(merged)
    half = (stride - 1) / 2.0
    conf = torch.clamp((1.0 / s) * EIGHT_PI, 0.0, 1.0)
    return torch.stack([sx / s * stride + half, sy / s * stride + half,
                        conf], dim=-1)


def hold(got, want, xy_bar, conf_bar=1e-5):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    dxy = float((got[..., :2].double() - want[..., :2].double()).abs().max())
    dc = float((got[..., 2].double() - want[..., 2].double()).abs().max())
    assert dxy <= xy_bar, (dxy, xy_bar)
    assert dc <= conf_bar, (dc, conf_bar)


# -- the CPU ----------------------------------------------------------------
@pytest.mark.parametrize("K", KEYPOINTS)
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_route_is_soft_argmax(kind, K):
    logits = heatmaps(kind, 2, H, W, K, seed=K)
    before = native.LAUNCHES["soft_argmax"]
    got = pose2d.soft_argmax_decode(logits, STRIDE)
    assert torch.equal(got, pose2d.soft_argmax(logits, STRIDE))
    assert native.LAUNCHES["soft_argmax"] == before


def test_sapiens_decode_on_the_cpu_is_unchanged():
    """``SapiensPose.decode``: soft_argmax's keypoints shifted by the
    crop's offset, and its confidences, bit for bit."""
    model = sapiens.SapiensPose(image_size=64, crop_width=48, dim=16,
                                depth=1, heads=2, mlp_dim=32, deconv=(8, 8),
                                conv=(8, 8), keypoints=308)
    logits = heatmaps("gaussian", 2, 64, 48, 308, seed=5)
    with torch.inference_mode():
        keypoints, conf = model.decode(logits)
    kp = pose2d.soft_argmax(logits, model.stride)
    assert torch.equal(keypoints, kp[..., :2] + torch.tensor([8.0, 0.0]))
    assert torch.equal(conf, kp[..., 2])


@pytest.mark.parametrize("slices", (1, 7, 32))
@pytest.mark.parametrize("K", KEYPOINTS)
@pytest.mark.parametrize("kind", KINDS)
def test_sliced_arithmetic_matches_soft_argmax(kind, K, slices):
    """The kernel's arithmetic with its row phases for K, at slice counts
    that do not divide the 667 pixels, within 1e-5 of the coordinate
    scale (the heatmap's extent in input pixels) and 1e-5 in the
    confidence."""
    logits = heatmaps(kind, 2, H, W, K, seed=K + slices)
    want = pose2d.soft_argmax(logits, STRIDE)
    got = sliced_soft_argmax(logits, STRIDE, slices,
                             kernel_rows(K, K % 4 == 0))
    hold(got, want, 1e-5 * max(H, W) * STRIDE)
    if kind == "flat":
        conf = EIGHT_PI / (H * W)
        centre = ((W - 1) / 2 * STRIDE + 1.5, (H - 1) / 2 * STRIDE + 1.5)
        assert float((got[..., 2] - conf).abs().max()) <= 1e-5 * conf
        for i in (0, 1):
            assert float((got[..., i] - centre[i]).abs().max()) <= 1e-4
    if kind == "peak":
        assert bool((got[..., 2] == 1).all())


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the soft_argmax kernel has no CPU "
                    "mode; chip_smoke.py phase 30 runs it on the card")
    return torch.device("cuda")


def hold_on_the_card(logits, got):
    hold(got, pose2d.soft_argmax(logits.double(), STRIDE).float(), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((32, 256, 192, 308), (3, 17, 13, 17),
                                   (1, 64, 48, 133), (2, 61, 47, 20),
                                   (1, 8, 6, 2052), (2, 9, 7, 517)),
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_the_plain_version(cuda, shape):
    """Sapiens' shape; COCO's 17 and COCO-WholeBody's 133 keypoints, one
    thread a keypoint (K % 4 != 0); 20 keypoints over pixels that the
    slices leave ragged; more keypoints than a block takes in one pass, by
    16-byte and by 4-byte loads.  Two launches a call, the same bits on a
    second call."""
    logits = heatmaps("gaussian", *shape, device=cuda, seed=sum(shape))
    before = native.LAUNCHES["soft_argmax"]
    with torch.inference_mode():
        got = pose2d.soft_argmax_decode(logits, STRIDE)
        again = pose2d.soft_argmax_decode(logits, STRIDE)
    torch.cuda.synchronize()
    assert native.LAUNCHES["soft_argmax"] == before + 4
    assert torch.equal(got, again)
    hold_on_the_card(logits, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("peak", "flat"))
@pytest.mark.parametrize("K", KEYPOINTS)
def test_cuda_kernel_on_peaked_and_flat_heatmaps(cuda, K, kind):
    logits = heatmaps(kind, 3, 64, 48, K, device=cuda, seed=K)
    with torch.inference_mode():
        got = pose2d.soft_argmax_decode(logits, STRIDE)
    hold_on_the_card(logits, got)


@pytest.mark.cuda
def test_cuda_kernel_reads_unaligned_logits(cuda):
    """Logits 4 bytes off a 16-byte boundary take the 4-byte loads."""
    logits = heatmaps("gaussian", 2, 40, 30, 20, device=cuda, seed=3)
    flat = torch.empty(logits.numel() + 1, device=cuda)
    shifted = flat[1:].view(logits.shape).copy_(logits)
    with torch.inference_mode():
        got = pose2d.soft_argmax_decode(shifted, STRIDE)
    hold_on_the_card(logits, got)


@pytest.mark.cuda
def test_cuda_refuses_what_it_does_not_take(cuda):
    logits = heatmaps("gaussian", 2, 16, 12, 20, device=cuda)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="contiguous"):
            pose2d.soft_argmax_decode(logits.transpose(1, 2))
        with pytest.raises(RuntimeError, match="dtype"):
            pose2d.soft_argmax_decode(logits.to(torch.bfloat16))
        for bad in (logits[0], logits[:, :0]):
            with pytest.raises(RuntimeError, match="at least 1"):
                pose2d.soft_argmax_decode(bad)
        empty = pose2d.soft_argmax_decode(logits[:0])
        assert empty.shape == (0, 20, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        pose2d.soft_argmax_decode(logits.clone().requires_grad_())
