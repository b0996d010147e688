"""Plain PyTorch reference of Sapiens pose: images -> (keypoints, confidences).

The model as the configuration states it (Khirodkar et al. 2024, Sapiens,
arXiv:2408.12569: mmpretrain's ``VisionTransformer`` at the ``sapiens_2b``
widths and mmpose's ``HeatmapHead``):

* the (B, S, S, 3) images' middle ``crop_width`` columns, a ``patch_size``
  convolution with padding ``patch_padding``, plus ``pos_embed`` (one
  entry a token, no cls token);
* ``depth`` blocks ``x += proj(attn(qkv(LN1(x))))``, then ``x +=
  fc2(GELU(fc1(LN2(x))))`` (LayerNorm eps 1e-6, ``num_heads`` heads of
  ``head_dim``, scale ``head_dim^-1/2``), then the final LayerNorm;
* the tokens as a (embed_dim, rows, columns) map; each deconvolution
  (kernel ``deconv_kernel``, stride 2, padding 1, no bias) and each 1 x 1
  convolution followed by inference BatchNorm as published, ``(x - mean) /
  sqrt(var + eps) * gamma + beta``, and ReLU; the final 1 x 1 convolution
  gives one heatmap of logits a keypoint;
* the decode: each heatmap's softmax over its pixels; the keypoint is the
  expected pixel, ``heatmap_stride`` x (column, row) + (stride - 1) / 2,
  plus the crop's column offset, in the frame's pixels; the confidence is
  the largest probability x 8 pi, clamped to [0, 1].

Attention is written out as ``softmax(Q K^T * head_dim^-1/2) V``, in blocks
of heads (one frame's scores are 1.2 GB a layer).  Everything is float32
with TF32 off, computed ``block`` frames at a time.  It reads only the
weights (mmpretrain's and mmpose's names, ``benchmark/models/
sapiens_vit.py``) and images the benchmark made; it imports nothing of the
program.

``operand`` rounds each operand of the patch convolution, of every Linear
and of every convolution of the head: the identity for the reference,
``hmr_smpl.fp8`` for the control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import hmr_smpl
from benchmark.reference.hmr2_smpl import ENCODER_EPS, layer_norm, linear
from benchmark.reference.hmr_smpl import Operand, exact

BN_EPS = 1e-5
HEAD_BLOCK = 8          # heads a block of the written-out attention
Weights = Dict[str, torch.Tensor]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(Q K^T * scale) V over (B, h, N, d), ``HEAD_BLOCK`` heads at
    a time -> (B, N, h * d)."""
    out = []
    for s in range(0, q.shape[1], HEAD_BLOCK):
        part = slice(s, s + HEAD_BLOCK)
        scores = q[:, part] @ k[:, part].transpose(-1, -2) * scale
        out.append(torch.softmax(scores, dim=-1) @ v[:, part])
        del scores
    y = torch.cat(out, dim=1)
    B, _, N, _ = y.shape
    return y.transpose(1, 2).reshape(B, N, -1)


def vit(w: Weights, images: torch.Tensor, cfg: dict,
        operand: Operand = exact) -> torch.Tensor:
    """(B, S, S, 3) NHWC images -> (B, tokens, embed_dim) after the final
    LayerNorm."""
    lo = (cfg["image_size"] - cfg["crop_width"]) // 2
    x = images[:, :, lo:lo + cfg["crop_width"]].permute(0, 3, 1, 2).float()
    x = F.conv2d(operand(x),
                 operand(w["backbone.patch_embed.projection.weight"].float()),
                 w["backbone.patch_embed.projection.bias"].float(),
                 stride=cfg["patch_size"], padding=cfg["patch_padding"])
    x = x.flatten(2).transpose(1, 2) + w["backbone.pos_embed"].float()
    H, d = cfg["num_heads"], cfg["head_dim"]
    for i in range(cfg["depth"]):
        b = f"backbone.layers.{i}."
        h = layer_norm(w, b + "ln1", x, ENCODER_EPS)
        B, N, _ = h.shape
        q, k, v = (t.reshape(B, N, H, d).transpose(1, 2) for t in
                   linear(w, b + "attn.qkv", h, operand).chunk(3, dim=-1))
        x = x + linear(w, b + "attn.proj", attention(q, k, v, d ** -0.5),
                       operand)
        h = layer_norm(w, b + "ln2", x, ENCODER_EPS)
        h = F.gelu(linear(w, b + "ffn.layers.0.0", h, operand))
        x = x + linear(w, b + "ffn.layers.1", h, operand)
    return layer_norm(w, "backbone.ln1", x, ENCODER_EPS)


def batch_norm(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm as published."""
    return F.batch_norm(x, w[name + ".running_mean"].float(),
                        w[name + ".running_var"].float(),
                        w[name + ".weight"].float(), w[name + ".bias"].float(),
                        training=False, eps=BN_EPS)


def head(w: Weights, tokens: torch.Tensor, cfg: dict,
         operand: Operand = exact) -> torch.Tensor:
    """(B, rows * columns, embed_dim) tokens -> (B, keypoints, 4 rows, 4
    columns) logits."""
    rows = cfg["image_size"] // cfg["patch_size"]
    x = tokens.transpose(1, 2).reshape(len(tokens), -1, rows,
                                       tokens.shape[1] // rows)
    for j in range(len(cfg["deconv_channels"])):
        name = f"head.deconv_layers.{3 * j}"
        x = F.conv_transpose2d(operand(x),
                               operand(w[name + ".weight"].float()),
                               stride=2, padding=1)
        x = torch.relu(batch_norm(w, f"head.deconv_layers.{3 * j + 1}", x))
    for j in range(len(cfg["conv_channels"])):
        name = f"head.conv_layers.{3 * j}"
        x = F.conv2d(operand(x), operand(w[name + ".weight"].float()),
                     w[name + ".bias"].float())
        x = torch.relu(batch_norm(w, f"head.conv_layers.{3 * j + 1}", x))
    return F.conv2d(operand(x), operand(w["head.final_layer.weight"].float()),
                    w["head.final_layer.bias"].float())


def decode(logits: torch.Tensor, cfg: dict
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, h, w) logits -> (keypoints (B, K, 2) in the frame's pixels,
    confidences (B, K))."""
    B, K, h, w = logits.shape
    prob = torch.softmax(logits.reshape(B, K, h * w), dim=-1)
    conf = torch.clamp(prob.amax(-1) * (8 * torch.pi), 0.0, 1.0)
    prob = prob.reshape(B, K, h, w)
    rows = torch.arange(h, dtype=prob.dtype, device=prob.device)
    cols = torch.arange(w, dtype=prob.dtype, device=prob.device)
    stride = cfg["heatmap_stride"]
    x = (prob.sum(2) * cols).sum(-1) * stride + (stride - 1) / 2
    y = (prob.sum(3) * rows).sum(-1) * stride + (stride - 1) / 2
    x = x + (cfg["image_size"] - cfg["crop_width"]) // 2
    return torch.stack([x, y], dim=-1), conf


@torch.no_grad()
def forward(weights: Weights, images: torch.Tensor, cfg: dict,
            operand: Operand = exact, block: int = 4
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (N, S, S, 3) -> (keypoints (N, K, 2), confidences (N, K)),
    float32, ``block`` frames at a time."""
    keypoints, confidences = [], []
    with hmr_smpl.no_tf32():
        for s in range(0, images.shape[0], block):
            logits = head(weights, vit(weights, images[s:s + block], cfg,
                                       operand), cfg, operand)
            kp, conf = decode(logits, cfg)
            keypoints.append(kp)
            confidences.append(conf)
            del logits
    return torch.cat(keypoints), torch.cat(confidences)
