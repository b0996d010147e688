"""2D keypoint detector: heatmap regression for BODY_25 + hands (port of
``tpubody.models.pose2d``).

Same output contract as the reference's OpenPose step: 67 keypoints
(BODY_25 + 2x21 hands, the layout ``fit.keypoints`` reads).  A
fully-convolutional encoder/decoder: strided convolutions down to 1/8,
a residual trunk, a transposed convolution up to 1/4-resolution
heatmaps; decoded by soft-argmax (the expectation over a spatial
softmax), differentiable and exact for unimodal Gaussian targets.

Three conventions of Flax that PyTorch does not share, each kept here:

  * ``nn.Conv``'s default ``padding="SAME"``: on a stride-2 convolution
    over an even input that pads (2, 3) for 7x7 and (0, 1) for 3x3, not
    PyTorch's symmetric padding, so every convolution pads explicitly
    (:func:`_same_pad`) and runs with ``padding=0``;
  * ``nn.GroupNorm``'s epsilon 1e-6 (PyTorch's default is 1e-5);
  * ``nn.ConvTranspose`` (``transpose_kernel=False``) is a convolution
    of the 2x-dilated input padded (2, 2) with the *unflipped* kernel;
    ``ConvTranspose2d(k=4, s=2, padding=1)`` computes the same with the
    kernel flipped in both spatial axes, so :func:`from_flax_variables`
    flips it ((H, W, I, O) -> (I, O, H, W)).

Images and heatmaps are NHWC at the interface, as in ``tpubody``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpubody_torch import native
from tpubody_torch.device import DeviceLike, resolve

N_KEYPOINTS = 67          # BODY_25 + left hand 21 + right hand 21
HEATMAP_STRIDE = 4
GN_EPS = 1e-6             # flax.linen.GroupNorm's default


class Pose2DOutput(NamedTuple):
    keypoints: torch.Tensor   # (B, K, 3) x, y (input pixels), conf
    heatmaps: torch.Tensor    # (B, H/4, W/4, K) logits


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's SAME does for a k x k, stride-s window:
    total max((ceil(n/s) - 1) * s + k - n, 0), the smaller half first."""
    pads = []
    for n in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Conv(nn.Conv2d):
    """A square convolution with Flax's SAME padding."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 bias: bool = False):
        super().__init__(c_in, c_out, k, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_same_pad(x, self.kernel_size[0],
                                         self.stride[0]))


class _ResBlock(nn.Module):
    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.conv0 = _Conv(c_in, features, 3)
        self.gn0 = nn.GroupNorm(8, features, eps=GN_EPS)
        self.conv1 = _Conv(features, features, 3)
        self.gn1 = nn.GroupNorm(8, features, eps=GN_EPS)
        self.proj = _Conv(c_in, features, 1) if c_in != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.gn0(self.conv0(x)))
        y = self.gn1(self.conv1(y))
        if self.proj is not None:
            x = self.proj(x)
        return torch.relu(x + y)


class Pose2D(nn.Module):
    """Heatmap keypoint network.  ``features`` scales capacity."""

    def __init__(self, n_keypoints: int = N_KEYPOINTS, features: int = 64,
                 n_blocks: int = 4):
        super().__init__()
        f = features
        self.n_keypoints = n_keypoints
        self.features = features
        self.down1 = _Conv(3, f, 7, 2)                  # 1/2
        self.down2 = _Conv(f, f * 2, 3, 2)              # 1/4
        self.down3 = _Conv(f * 2, f * 4, 3, 2)          # 1/8
        self.blocks = nn.Sequential(*[_ResBlock(f * 4, f * 4)
                                      for _ in range(n_blocks)])
        self.up = nn.ConvTranspose2d(f * 4, f * 2, 4, stride=2, padding=1)
        self.head = nn.Conv2d(f * 2, n_keypoints, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3), H and W divisible by 8 -> heatmap logits
        (B, H/4, W/4, n_keypoints)."""
        x = images.permute(0, 3, 1, 2).to(self.down1.weight.dtype)
        x = torch.relu(self.down1(x))
        x = torch.relu(self.down2(x))
        x = torch.relu(self.down3(x))
        x = self.blocks(x)
        x = torch.relu(self.up(x))
        return self.head(x).permute(0, 2, 3, 1)


def soft_argmax(logits: torch.Tensor,
                stride: int = HEATMAP_STRIDE) -> torch.Tensor:
    """(B, h, w, K) logits -> (B, K, 3) x, y in input pixels + confidence.

    Expectation under the per-keypoint spatial softmax; confidence is the
    peak probability scaled so an ideal 2 px-sigma Gaussian gives ~1."""
    B, h, w, K = logits.shape
    prob = torch.softmax(logits.reshape(B, h * w, K), dim=1)
    pmax = prob.max(dim=1).values                      # (B, K)
    prob = prob.reshape(B, h, w, K)
    py = prob.sum(dim=2)                               # (B, h, K)
    px = prob.sum(dim=1)                               # (B, w, K)
    grid_y = torch.arange(h, dtype=prob.dtype, device=prob.device)
    grid_x = torch.arange(w, dtype=prob.dtype, device=prob.device)
    y = torch.einsum("bhk,h->bk", py, grid_y)
    x = torch.einsum("bwk,w->bk", px, grid_x)
    # to input pixel coordinates (center of the stride cell)
    x = x * stride + (stride - 1) / 2.0
    y = y * stride + (stride - 1) / 2.0
    conf = torch.clamp(pmax * (2.0 * math.pi * 4.0), 0.0, 1.0)
    return torch.stack([x, y, conf], dim=-1)


def soft_argmax_decode(logits: torch.Tensor,
                       stride: int = HEATMAP_STRIDE) -> torch.Tensor:
    """:func:`soft_argmax` for inference: (B, h, w, K) float32 logits ->
    (B, K, 3) x, y in input pixels + confidence, float32.

    On CUDA two launches of ``csrc/soft_argmax.cu``, which reads the
    logits once: contiguous float32 (B, h, w, K), h, w and K at least 1,
    and no autograd (the kernel has no backward).  Its sums are taken in
    another order than :func:`soft_argmax`'s, so the answers differ from
    it in the last bits.  Anything else it does not take raises
    RuntimeError.  The CPU runs :func:`soft_argmax`."""
    if logits.device.type == "cpu":
        return soft_argmax(logits, stride)
    dev = logits.device
    if dev.type != "cuda" or logits.dim() != 4 or 0 in logits.shape[1:]:
        raise RuntimeError(
            f"soft_argmax_decode takes (B, h, w, K) logits on CUDA or the "
            f"CPU, h, w and K at least 1; got {tuple(logits.shape)} on {dev}")
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("soft_argmax_decode has no backward on CUDA: call "
                           "it under torch.no_grad() or inference mode")
    B, h, w, K = logits.shape
    native.expect("logits", logits, logits.shape, torch.float32, dev)
    out = torch.empty((B, K, 3), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    vec = int(K % 4 == 0 and logits.data_ptr() % 16 == 0)
    slices = ctypes.c_int()
    with torch.cuda.device(dev):
        native.check(native.library().tpubody_soft_argmax_slices(
            B, h, w, K, vec, ctypes.byref(slices)), "soft_argmax slices")
    part = torch.empty((B, slices.value, 4, K), dtype=torch.float32,
                       device=dev)
    native.launch("soft_argmax", "tpubody_soft_argmax", dev,
                  logits.data_ptr(), part.data_ptr(), out.data_ptr(),
                  B, h, w, K, vec, slices.value, float(stride), count=2)
    return out


def detect(model: Pose2D, images: torch.Tensor) -> Pose2DOutput:
    """images (B, H, W, 3) -> keypoints (B, K, 3) and heatmap logits."""
    logits = model(images)
    return Pose2DOutput(keypoints=soft_argmax(logits), heatmaps=logits)


@torch.no_grad()
def init_weights(model: Pose2D, seed: int = 0) -> None:
    """Seeded LeCun-normal convolutions (the Flax default) on the CPU
    generator, so a seed gives the same weights on every device; zero
    biases, identity GroupNorm."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen)
                    / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()


def create_pose2d(n_keypoints: int = N_KEYPOINTS, features: int = 64,
                  n_blocks: int = 4, seed: int = 0,
                  device: DeviceLike = "cuda") -> Pose2D:
    """A Pose2D with seeded random weights on ``device``."""
    model = Pose2D(n_keypoints=n_keypoints, features=features,
                   n_blocks=n_blocks)
    init_weights(model, seed)
    return model.to(resolve(device))


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """A ``tpubody`` Pose2D variable tree ``{"params": ...}`` (numpy
    leaves) -> this package's state_dict (HWIO kernels to OIHW; the
    transposed convolution's kernel flipped spatially, see the module
    docstring)."""
    p = variables["params"]

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def conv(kernel):
        return t(kernel).permute(3, 2, 0, 1).contiguous()

    sd = {"down1.weight": conv(p["Conv_0"]["kernel"]),
          "down2.weight": conv(p["Conv_1"]["kernel"]),
          "down3.weight": conv(p["Conv_2"]["kernel"]),
          "up.weight": t(p["ConvTranspose_0"]["kernel"]).flip(0, 1)
          .permute(2, 3, 0, 1).contiguous(),
          "up.bias": t(p["ConvTranspose_0"]["bias"]),
          "head.weight": conv(p["Conv_3"]["kernel"]),
          "head.bias": t(p["Conv_3"]["bias"])}
    blocks = sorted((k for k in p if k.startswith("_ResBlock_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(blocks):
        bp = p[name]
        for j in (0, 1):
            sd[f"blocks.{i}.conv{j}.weight"] = conv(bp[f"Conv_{j}"]["kernel"])
            sd[f"blocks.{i}.gn{j}.weight"] = t(bp[f"GroupNorm_{j}"]["scale"])
            sd[f"blocks.{i}.gn{j}.bias"] = t(bp[f"GroupNorm_{j}"]["bias"])
        if "Conv_2" in bp:
            sd[f"blocks.{i}.proj.weight"] = conv(bp["Conv_2"]["kernel"])
    return sd


# --- training -----------------------------------------------------------

def make_target_heatmaps(keypoints: torch.Tensor, hw: Tuple[int, int],
                         sigma: float = 2.0,
                         stride: int = HEATMAP_STRIDE) -> torch.Tensor:
    """(B, K, 3) pixel keypoints -> (B, h, w, K) Gaussian targets.
    Keypoints with conf <= 0 produce all-zero maps (masked in the loss)."""
    h, w = hw
    cy = (keypoints[..., 1] - (stride - 1) / 2.0) / stride   # (B, K)
    cx = (keypoints[..., 0] - (stride - 1) / 2.0) / stride
    yy = torch.arange(h, dtype=keypoints.dtype,
                      device=keypoints.device)[None, :, None, None]
    xx = torch.arange(w, dtype=keypoints.dtype,
                      device=keypoints.device)[None, None, :, None]
    d2 = ((yy - cy[:, None, None, :]) ** 2
          + (xx - cx[:, None, None, :]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    valid = (keypoints[..., 2] > 0).to(keypoints.dtype)
    return g * valid[:, None, None, :]


def heatmap_loss(logits: torch.Tensor, keypoints: torch.Tensor,
                 sigma: float = 2.0) -> torch.Tensor:
    """Softmax cross-entropy against normalized Gaussian targets, masked by
    keypoint validity — scale-invariant and matched to soft-argmax."""
    B, h, w, K = logits.shape
    target = make_target_heatmaps(keypoints, (h, w), sigma)
    tflat = target.reshape(B, h * w, K)
    tnorm = tflat / torch.clamp(tflat.sum(dim=1, keepdim=True), min=1e-6)
    logp = torch.log_softmax(logits.reshape(B, h * w, K), dim=1)
    valid = (keypoints[..., 2] > 0).to(logits.dtype)
    ce = -(tnorm * logp).sum(dim=1)                  # (B, K)
    return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def make_train_step(model: Pose2D, optimizer: torch.optim.Optimizer):
    """Returns ``step(images, keypoints) -> loss``: one optimizer step on
    :func:`heatmap_loss`, updating ``model`` in place (the loss stays on
    the device)."""

    def step(images: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = heatmap_loss(model(images), keypoints)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def keypoints_to_openpose(keypoints: np.ndarray) -> dict:
    """(67, 3) -> the OpenPose JSON people-entry layout
    (pose_keypoints_2d 75, hand_left/right_keypoints_2d 63 each)."""
    kp = np.asarray(keypoints, np.float64)
    return {
        "pose_keypoints_2d": kp[:25].reshape(-1).tolist(),
        "hand_left_keypoints_2d": kp[25:46].reshape(-1).tolist(),
        "hand_right_keypoints_2d": kp[46:67].reshape(-1).tolist(),
    }
