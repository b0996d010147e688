"""Plain PyTorch reference of HMR 2.0 + SMPL: images -> (posed vertices,
camera).

The model as 4D-Humans writes it (Goel et al. 2023, arXiv:2305.20091:
``hmr2/models/backbones/vit.py``, ``hmr2/models/heads/smpl_head.py``,
``hmr2/models/components/pose_transformer.py``), with ViTPose's ViT-H/16
(Xu et al. 2022, arXiv:2204.12484) as its encoder:

* the (B, S, S, 3) images' middle ``crop_width`` columns, a
  ``patch_size`` convolution with padding ``patch_padding``, plus
  ``pos_embed[:, 1:] + pos_embed[:, :1]``;
* ``depth`` blocks ``x += proj(attn(qkv(LN1(x))))``, then ``x +=
  fc2(GELU(fc1(LN2(x))))`` (LayerNorm eps 1e-6, ``num_heads`` heads), then
  ``last_norm``;
* the decoder: a zero token through ``to_token_embedding`` plus
  ``pos_embedding``, then ``decoder_depth`` layers ``x += SA(LN(x)); x +=
  CA(LN(x), tokens); x += FF(LN(x))`` (LayerNorm eps 1e-5, ``to_qkv``,
  ``to_q`` and ``to_kv`` without bias);
* ``decpose``, ``decshape`` and ``deccam`` added to ``init_body_pose``,
  ``init_betas`` and ``init_cam`` once; the 6D pose read as 4D-Humans
  reads it, each joint's two columns one after the other, and Gram-Schmidt;
* SMPL (Loper et al. 2015) by linear blend skinning, as ``hmr_smpl``.

Attention is written out as ``softmax(Q K^T * scale) V``.  Everything is
float32 with TF32 off, computed in blocks of frames.  It reads only the
weights (4D-Humans' names, ``benchmark/models/hmr2_vith.py``), body and
images the benchmark made; it imports nothing of the program.

``operand`` rounds each operand of the patch convolution and of every
Linear of the encoder and the decoder: the identity for the reference,
``hmr_smpl.fp8`` for the control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import hmr_smpl
from benchmark.reference.hmr_smpl import Operand, exact

ENCODER_EPS = 1e-6
DECODER_EPS = 1e-5
Weights = Dict[str, torch.Tensor]


def _f32(w: Weights, name: str) -> torch.Tensor:
    return w[name].float()


def linear(w: Weights, name: str, x: torch.Tensor, operand: Operand,
           bias: bool = True) -> torch.Tensor:
    b = _f32(w, name + ".bias") if bias else None
    return F.linear(operand(x), operand(_f32(w, name + ".weight")), b)


def layer_norm(w: Weights, name: str, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], _f32(w, name + ".weight"),
                        _f32(w, name + ".bias"), eps)


def heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, N, h * d) -> (B, h, N, d)."""
    B, N, _ = x.shape
    return x.reshape(B, N, n_heads, -1).transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """softmax(Q K^T * d^-1/2) V over (B, h, N, d) -> (B, N, h * d)."""
    scores = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    y = torch.softmax(scores, dim=-1) @ v
    B, _, N, _ = y.shape
    return y.transpose(1, 2).reshape(B, N, -1)


def vit(w: Weights, images: torch.Tensor, cfg: dict,
        operand: Operand = exact) -> torch.Tensor:
    """(B, S, S, 3) NHWC images -> (B, tokens, embed_dim) after
    ``last_norm``."""
    lo = (cfg["image_size"] - cfg["crop_width"]) // 2
    x = images[:, :, lo:lo + cfg["crop_width"]].permute(0, 3, 1, 2).float()
    x = F.conv2d(operand(x),
                 operand(_f32(w, "backbone.patch_embed.proj.weight")),
                 _f32(w, "backbone.patch_embed.proj.bias"),
                 stride=cfg["patch_size"], padding=cfg["patch_padding"])
    x = x.flatten(2).transpose(1, 2)
    pos = _f32(w, "backbone.pos_embed")
    x = x + pos[:, 1:] + pos[:, :1]
    for i in range(cfg["depth"]):
        b = f"backbone.blocks.{i}."
        h = layer_norm(w, b + "norm1", x, ENCODER_EPS)
        q, k, v = (heads(t, cfg["num_heads"]) for t in
                   linear(w, b + "attn.qkv", h, operand).chunk(3, dim=-1))
        x = x + linear(w, b + "attn.proj", attention(q, k, v), operand)
        h = layer_norm(w, b + "norm2", x, ENCODER_EPS)
        h = F.gelu(linear(w, b + "mlp.fc1", h, operand))
        x = x + linear(w, b + "mlp.fc2", h, operand)
    return layer_norm(w, "backbone.last_norm", x, ENCODER_EPS)


def decoder(w: Weights, tokens: torch.Tensor, cfg: dict,
            operand: Operand = exact) -> torch.Tensor:
    """Encoder tokens (B, N, context_dim) -> the decoder's token (B,
    decoder_dim)."""
    t = "smpl_head.transformer."
    n_heads = cfg["decoder_heads"]
    zero = torch.zeros((tokens.shape[0], 1, cfg["token_dim"]),
                       device=tokens.device)
    x = (linear(w, t + "to_token_embedding", zero, operand)
         + _f32(w, t + "pos_embedding"))
    for i in range(cfg["decoder_depth"]):
        layer = f"{t}transformer.layers.{i}."
        h = layer_norm(w, layer + "0.norm", x, DECODER_EPS)
        q, k, v = (heads(u, n_heads) for u in linear(
            w, layer + "0.fn.to_qkv", h, operand, bias=False).chunk(3, -1))
        x = x + linear(w, layer + "0.fn.to_out.0", attention(q, k, v),
                       operand)
        h = layer_norm(w, layer + "1.norm", x, DECODER_EPS)
        k, v = (heads(u, n_heads) for u in linear(
            w, layer + "1.fn.to_kv", tokens, operand, bias=False).chunk(2, -1))
        q = heads(linear(w, layer + "1.fn.to_q", h, operand, bias=False),
                  n_heads)
        x = x + linear(w, layer + "1.fn.to_out.0", attention(q, k, v),
                       operand)
        h = layer_norm(w, layer + "2.norm", x, DECODER_EPS)
        h = F.gelu(linear(w, layer + "2.fn.net.0", h, operand))
        x = x + linear(w, layer + "2.fn.net.3", h, operand)
    return x[:, 0]


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """4D-Humans' 6D rotations (..., 6): the two columns one after the
    other (``x.reshape(-1, 2, 3).permute(0, 2, 1)``) -> (..., 3, 3);
    ``hmr_smpl.rot6d_to_rotmat`` reads the (3, 2) layout."""
    cols = x.reshape(x.shape[:-1] + (2, 3)).transpose(-1, -2)
    return hmr_smpl.rot6d_to_rotmat(cols.reshape(x.shape))


def regress(w: Weights, images: torch.Tensor, cfg: dict,
            operand: Operand = exact):
    """Images -> (rotation matrices (B, J, 3, 3), betas (B, 10), camera
    (B, 3), the 6D pose (B, 6 J) in 4D-Humans' layout)."""
    h = decoder(w, vit(w, images, cfg, operand), cfg, operand)

    def readout(dec, init):
        return (F.linear(h, _f32(w, f"smpl_head.{dec}.weight"),
                         _f32(w, f"smpl_head.{dec}.bias"))
                + _f32(w, f"smpl_head.{init}"))

    pose = readout("decpose", "init_body_pose")
    betas = readout("decshape", "init_betas")
    cam = readout("deccam", "init_cam")
    rotmats = rot6d_to_rotmat(pose.reshape(len(h), -1, 6))
    return rotmats, betas, cam, pose


@torch.no_grad()
def forward(weights: Weights, body: Dict[str, torch.Tensor], parents,
            images: torch.Tensor, cfg: dict, operand: Operand = exact,
            block: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (N, S, S, 3) -> (vertices (N, V, 3), camera (N, 3)),
    float32, ``block`` frames at a time."""
    verts, cams = [], []
    with hmr_smpl.no_tf32():
        for s in range(0, images.shape[0], block):
            rotmats, betas, cam, _ = regress(weights, images[s:s + block],
                                             cfg, operand)
            verts.append(hmr_smpl.smpl_vertices(body, parents, rotmats,
                                                betas))
            cams.append(cam)
    return torch.cat(verts), torch.cat(cams)
