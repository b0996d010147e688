"""Plain PyTorch reference of HMR + SMPL with the backbone under post-training
integer quantization, as the int8 configuration states it.

From the float32 weights the benchmark made:

* fold each inference BatchNorm into its convolution, in float32:
  ``g = gamma / sqrt(var + eps)`` (the square root correctly rounded),
  ``w' = w * g``, ``b' = beta - mean * g``;
* calibrate: the folded float32 network (TF32 off) on the calibration
  images; each convolution's input scale is ``max(absmax, 1e-8) / qmax``
  (divided in float64, rounded once to float32);
* quantize each folded weight per output channel, scale
  ``max(absmax, 1e-12) / qmax``, codes ``clip(round(w' / s), -qmax, qmax)``;
* at run time each convolution rounds its input to codes by division,
  ``clip(round(x / s_x), -qmax, qmax)``, sums the integer products exactly
  (in float64: every sum is below 2^53), and dequantizes into float32:
  ``acc * (s_x * s_w) + b'``; ReLU and the residual add stay float32.

The IEF head and the skinning are float32 (:mod:`hmr_smpl`).  ``bits`` is
8 for the reference and 4 for the control (qmax 127 and 7).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import hmr_smpl

BN_EPS = 1e-5


def qmax_of(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _convs(stage_sizes) -> List[Tuple[str, str, int, int]]:
    """(conv name, BatchNorm name, stride, padding) of every convolution,
    in the order the forward pass meets them."""
    out = [("conv1", "bn1", 2, 3)]
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            p = f"layer{i + 1}.{j}"
            stride = 2 if (j == 0 and i > 0) else 1
            out += [(p + ".conv1", p + ".bn1", 1, 0),
                    (p + ".conv2", p + ".bn2", stride, 1),
                    (p + ".conv3", p + ".bn3", 1, 0)]
            if j == 0:
                out.append((p + ".downsample.0", p + ".downsample.1",
                            stride, 0))
    return out


def fold(weights: Dict[str, torch.Tensor], stage_sizes) -> Dict[str, tuple]:
    """conv name -> (folded OIHW weight, bias, stride, padding), float32."""
    folded = {}
    for name, bn, stride, padding in _convs(stage_sizes):
        g = weights[bn + ".weight"].float() / torch.sqrt(
            (weights[bn + ".running_var"].float() + BN_EPS).double()).float()
        w = weights[name + ".weight"].float() * g[:, None, None, None]
        b = weights[bn + ".bias"].float() - weights[bn + ".running_mean"] * g
        folded[name] = (w, b, stride, padding)
    return folded


def _network(folded, x: torch.Tensor, stage_sizes, conv) -> torch.Tensor:
    """The folded backbone on NCHW float32, each convolution through
    ``conv(name, x)`` -> (B, 2048) pooled features."""
    x = F.max_pool2d(torch.relu(conv("conv1", x)), 3, stride=2, padding=1)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            p = f"layer{i + 1}.{j}"
            y = torch.relu(conv(p + ".conv1", x))
            y = torch.relu(conv(p + ".conv2", y))
            y = conv(p + ".conv3", y)
            res = conv(p + ".downsample.0", x) if j == 0 else x
            x = torch.relu(y + res)
    return x.mean(dim=(2, 3))


@torch.no_grad()
def calibrate(folded, images: torch.Tensor, stage_sizes,
              bits: int) -> Dict[str, torch.Tensor]:
    """conv name -> input scale, from the folded float32 network on the
    calibration images (N, H, W, 3)."""
    maxima = {}

    def conv(name, x):
        w, b, stride, padding = folded[name]
        maxima[name] = x.abs().amax()
        return F.conv2d(x, w, b, stride=stride, padding=padding)

    with hmr_smpl.no_tf32():
        _network(folded, images.permute(0, 3, 1, 2).float(), stage_sizes,
                 conv)
    return {k: (torch.clamp(v.double(), min=1e-8) / qmax_of(bits)).float()
            for k, v in maxima.items()}


def quantize(folded, scales, bits: int) -> Dict[str, tuple]:
    """conv name -> (integer codes as float64 OIHW, weight scales (O,), bias,
    input scale, stride, padding)."""
    qmax = qmax_of(bits)
    out = {}
    for name, (w, b, stride, padding) in folded.items():
        s_w = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / qmax
        codes = torch.clamp(torch.round(w / s_w[:, None, None, None]),
                            -qmax, qmax)
        out[name] = (codes.double(), s_w, b, scales[name], stride, padding)
    return out


def backbone(qparams, images: torch.Tensor, stage_sizes,
             bits: int) -> torch.Tensor:
    """The quantized backbone: (B, H, W, 3) NHWC -> (B, 2048)."""
    qmax = qmax_of(bits)

    def conv(name, x):
        codes, s_w, b, s_x, stride, padding = qparams[name]
        xq = torch.clamp(torch.round(x / s_x), -qmax, qmax).double()
        acc = F.conv2d(xq, codes, stride=stride, padding=padding).float()
        return acc * (s_x * s_w)[:, None, None] + b[:, None, None]

    return _network(qparams, images.permute(0, 3, 1, 2).float(), stage_sizes,
                    conv)


@torch.no_grad()
def prepare(weights, calib_images: torch.Tensor, stage_sizes,
            bits: int) -> Dict[str, tuple]:
    """Fold, calibrate and quantize from the float32 weights."""
    folded = fold(weights, stage_sizes)
    return quantize(folded, calibrate(folded, calib_images, stage_sizes,
                                      bits), bits)


@torch.no_grad()
def forward(qparams, weights, body, parents, mean_params, images: torch.Tensor,
            stage_sizes, n_iter: int, bits: int = 8, block: int = 32):
    """Images (N, H, W, 3) -> (vertices (N, V, 3), camera (N, 3)), with
    ``qparams`` from :func:`prepare`."""
    verts, cams = [], []
    with hmr_smpl.no_tf32():
        for s in range(0, images.shape[0], block):
            feats = backbone(qparams, images[s:s + block], stage_sizes, bits)
            rotmats, betas, cam = hmr_smpl.ief(weights, feats, mean_params,
                                               n_iter)
            verts.append(hmr_smpl.smpl_vertices(body, parents, rotmats,
                                                betas))
            cams.append(cam)
    return torch.cat(verts), torch.cat(cams)
