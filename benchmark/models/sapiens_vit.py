"""Seeded weights of Sapiens pose (the ViT encoder and mmpose's heatmap head),
made on the device, under mmpretrain's and mmpose's names
(``backbone.patch_embed.projection``, ``backbone.layers.{i}.attn.qkv``, ...,
``backbone.ln1``, ``head.deconv_layers.{0,1,3,4}``,
``head.conv_layers.{0,1,3,4}``, ``head.final_layer``).  Trained weights are
not in the repository; these stand in for them at the same shapes, so that
activations keep their scale through the 48 blocks and the head, and
different images give clearly different heatmaps:

* the encoder's Linears N(0, gain^2 / fan_in), so that each branch keeps
  its scale at any width (mmpretrain draws N(0, 0.02^2), a gain of 0.876
  at a fan-in of 1,920): the query and key rows of ``qkv`` at ``QK_GAIN``,
  so that the attention scores have a std of about ``QK_GAIN``^2 and each
  head attends to a few tokens, as a trained one does (at 0.02 they read
  0.77, the softmax is near flat and a wrong scale does not show at all);
  the value rows and ``proj`` at ``ATTENTION_GAIN``, ``fc1`` and ``fc2`` at
  ``MLP_GAIN``, so that attention does most of each block's work.  These
  gains were chosen on the card among 16 variants (PERF.md §2): at
  ``QK_GAIN`` 2.2 and above a bf16 step and a float32 reference run apart
  through the 48 blocks.  Every bias N(0, 0.02^2) where mmpretrain starts
  from zero, so that a dropped bias shows; the patch convolution and its
  bias U(+-1/sqrt(768)), PyTorch's default; ``pos_embed`` N(0, 0.02^2);
* every LayerNorm's scale U(0.8, 1.2) and bias N(0, 0.02^2) where the
  published models start from (1, 0), so that a swap of the two shows;
* each deconvolution N(0, 1 / (4 c_in)) (a k = 4, stride 2 output pixel
  sums 4 taps of each input channel) and each 1 x 1 convolution N(0, 2 /
  c_in) with a bias N(0, 0.02^2), where mmpose draws N(0, 0.001^2): at
  0.001 every heatmap would be flat;
* every BatchNorm away from the identity that mmpose starts from, as a
  trained one is: gamma U(0.5, 1.5), beta N(0, 0.3^2), running mean N(0,
  0.3^2), running variance U(0.5, 2), so that each channel's scale lies in
  about (0.35, 2.1) and a dropped BatchNorm moves every heatmap;
* ``final_layer`` N(0, ``FINAL_GAIN``^2 2 / c_in) with a zero bias: the
  gain sets how sharp each keypoint's heatmap is.  At 6 the keypoints move
  by tens of pixels from frame to frame (30-40 px a keypoint, the median
  over keypoints) and the confidences (the peak probability x 8 pi) lie
  mostly in (0.003, 0.6), clamped at 1 on under 0.1% of keypoints: a
  confidence clamped on every frame would not vary, and the comparison
  divides by how much it varies.  At 4 the keypoints moved by 17-20 px.

All values come from two generator calls on the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import seeding

QK_GAIN = 1.8
ATTENTION_GAIN = 1.5
MLP_GAIN = 0.5
BIAS_STD = 0.02
NORM_BIAS_STD = 0.02
BN_SHIFT_STD = 0.3
BN_VAR = (0.5, 2.0)
FINAL_GAIN = 6.0
Shape = Tuple[int, ...]
# (name, shape, draw, scale): "normal" is N(0, scale^2), "uniform"
# U(-scale, scale), "norm" a scale 1 + U(-scale, scale), "variance"
# U(BN_VAR), "qkv" N(0, scale^2) with the query and key rows at QK_GAIN.
Entry = Tuple[str, Shape, str, float]


def entries(cfg: dict) -> List[Entry]:
    """Every weight of the configuration but the final layer's zero bias."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    out: List[Entry] = []

    def norm(name, width):
        out.extend([(name + ".weight", (width,), "norm", 0.2),
                    (name + ".bias", (width,), "normal", NORM_BIAS_STD)])

    def linear(name, n_out, n_in, gain, draw="normal"):
        out.extend([(name + ".weight", (n_out, n_in), draw,
                     gain / n_in ** 0.5),
                    (name + ".bias", (n_out,), "normal", BIAS_STD)])

    def batch_norm(name, width):
        out.extend([(name + ".weight", (width,), "norm", 0.5),
                    (name + ".bias", (width,), "normal", BN_SHIFT_STD),
                    (name + ".running_mean", (width,), "normal",
                     BN_SHIFT_STD),
                    (name + ".running_var", (width,), "variance", 0.0)])

    b = "backbone."
    fan = 3 * p * p
    rows = cfg["image_size"] // p
    cols = cfg["crop_width"] // p
    out.extend([(b + "patch_embed.projection.weight", (d, 3, p, p),
                 "uniform", fan ** -0.5),
                (b + "patch_embed.projection.bias", (d,), "uniform",
                 fan ** -0.5),
                (b + "pos_embed", (1, rows * cols, d), "normal",
                 BIAS_STD)])
    for i in range(cfg["depth"]):
        layer = f"{b}layers.{i}."
        norm(layer + "ln1", d)
        linear(layer + "attn.qkv", 3 * d, d, ATTENTION_GAIN, "qkv")
        linear(layer + "attn.proj", d, d, ATTENTION_GAIN)
        norm(layer + "ln2", d)
        linear(layer + "ffn.layers.0.0", cfg["mlp_dim"], d, MLP_GAIN)
        linear(layer + "ffn.layers.1", d, cfg["mlp_dim"], MLP_GAIN)
    norm(b + "ln1", d)

    h, c_in, k = "head.", d, cfg["deconv_kernel"]
    for j, c_out in enumerate(cfg["deconv_channels"]):
        out.append((f"{h}deconv_layers.{3 * j}.weight", (c_in, c_out, k, k),
                    "normal", (4 * c_in) ** -0.5))
        batch_norm(f"{h}deconv_layers.{3 * j + 1}", c_out)
        c_in = c_out
    for j, c_out in enumerate(cfg["conv_channels"]):
        out.extend([(f"{h}conv_layers.{3 * j}.weight", (c_out, c_in, 1, 1),
                     "normal", (2 / c_in) ** 0.5),
                    (f"{h}conv_layers.{3 * j}.bias", (c_out,), "normal",
                     NORM_BIAS_STD)])
        batch_norm(f"{h}conv_layers.{3 * j + 1}", c_out)
        c_in = c_out
    out.append((h + "final_layer.weight", (cfg["keypoints"], c_in, 1, 1),
                "normal", FINAL_GAIN * (2 / c_in) ** 0.5))
    return out


@torch.no_grad()
def make(seed: int, device, cfg: dict) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``."""
    gen = seeding.generator(seed, "sapiens_vit.weights", device)
    table = entries(cfg)
    drawn = {"normal": [e for e in table if e[2] in ("normal", "qkv")],
             "uniform": [e for e in table
                         if e[2] not in ("normal", "qkv")]}
    w: Dict[str, torch.Tensor] = {}
    lo, hi = BN_VAR
    for kind, group in drawn.items():
        sizes = [math.prod(shape) for _, shape, _, _ in group]
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, how, scale), t in zip(group,
                                                torch.split(flat, sizes)):
            t = t.view(shape)
            if how == "variance":
                t.mul_(hi - lo).add_(lo)
            elif how in ("uniform", "norm"):
                t.mul_(2).sub_(1).mul_(scale)
                if how == "norm":
                    t.add_(1.0)
            else:
                t.mul_(scale)
                if how == "qkv":             # the query and key rows
                    d = shape[1]
                    t[:2 * d].mul_(QK_GAIN / d ** 0.5 / scale)
            w[name] = t
    w["head.final_layer.bias"] = torch.zeros(cfg["keypoints"], device=device)
    return w


def served(weights: Dict[str, torch.Tensor],
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights in the type they are served in: the patch convolution,
    every Linear and every convolution of the head (weights and biases; the
    final layer's weight) in ``dtype``; the LayerNorms, the position table,
    the BatchNorms and the final layer's bias float32.  Each is a tensor of
    its own: none holds on to the draws :func:`make` sliced the weights
    from."""
    low = ("patch_embed.projection", ".attn.", ".ffn.",
           "final_layer.weight")

    def is_low(name):
        if any(s in name for s in low):
            return True
        parts = name.split(".")      # head.{deconv,conv}_layers.{3 j}.*
        return parts[1].endswith("_layers") and int(parts[2]) % 3 == 0

    return {k: v.to(dtype) if is_low(k) else v.clone()
            for k, v in weights.items()}


def parameter_count(cfg: dict, part: str = "backbone.") -> int:
    """The parameters under ``part`` ("backbone." the encoder, "head." the
    heatmap head; BatchNorms' running statistics are not parameters)."""
    return sum(math.prod(shape) for name, shape, _, _ in entries(cfg)
               if name.startswith(part) and "running_" not in name) + (
        cfg["keypoints"] if part == "head." else 0)
