"""Seeded weights of Multi-HMR 896-L (DINOv2 ViT-L/14 encoder, the Human
Prediction Head and its readouts), made on the device, under DINOv2's and
Multi-HMR's names (``backbone.encoder.blocks.{i}.attn.qkv``, ...,
``backbone.encoder.blocks.{i}.ls1.gamma``, ``x_attention_head.transformer.
transformer.layers.{i}.{0,1,2}``, ``x_attention_head.decpose``,
``x_attention_head.init_body_pose``).  Trained weights are not in the
repository; these stand in for them at the same shapes, close to the
published initialisations, so that activations keep their scale through the
24 blocks and different images give clearly different bodies:

* the encoder's Linears N(0, 0.02^2) (DINOv2's truncated normal, whose cut
  at +-2 does nothing at this std), their biases N(0, 0.02^2) where DINOv2
  starts from zero, so that a dropped bias shows; the patch convolution and
  its bias U(+-1/sqrt(588)), PyTorch's default; ``cls_token`` and
  ``pos_embed`` N(0, 0.02^2);
* LayerScale ``ls1.gamma`` and ``ls2.gamma`` U(0.1, 0.5) a channel, where
  DINOv2 starts from 1e-5: at 1e-5 the 24 blocks would leave the stream as
  the patch embedding made it and the check would not see them; at these
  values each branch moves the stream by a share of its size, as a trained
  model's do;
* every LayerNorm's scale U(0.8, 1.2) and bias N(0, 0.02^2) where the
  published models start from (1, 0), so that a swap of the two shows;
* the head's Linears and biases U(+-1/sqrt(fan_in)), PyTorch's default,
  ``pos_embedding`` N(0, 1) as 4D-Humans draws it, the row and column
  embeddings N(0, 0.1^2);
* ``decpose``, ``decshape``, ``deccam``, ``decexpression`` and the offset
  head's last layer normal with std ``gain / sqrt(fan_in)`` less each row's
  mean, bias 0, as ``hmr_r50`` makes its decoders; the gain of ``decshape``
  and ``decexpression`` (``SHAPE_GAIN``) gives betas and expression
  coefficients of about unit size, as SMPL-X's are (both are coefficients
  of principal components of unit variance), so that each moves the
  vertices by centimetres and a dropped or misplaced column shows;
* ``init_body_pose``, ``init_betas`` and ``init_cam``: :func:`mean_params`.

All values but the mean parameters come from two generator calls on the
device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import seeding

READOUT_GAIN = 0.03
SHAPE_GAIN = 0.75
OFFSET_GAIN = 0.5
ENCODER_STD = 0.02
NORM_BIAS_STD = 0.02
EMBED_STD = 0.1
LAYERSCALE = (0.1, 0.5)
MEAN_POSE_RADIANS = 0.4
MEAN_DEPTH = 5.0          # metres
Shape = Tuple[int, ...]
# (name, shape, draw, scale): "normal" is N(0, scale^2), "uniform"
# U(-scale, scale), "norm" a LayerNorm scale 1 + U(-scale, scale),
# "layerscale" U(LAYERSCALE), "readout" normal less each row's mean.
Entry = Tuple[str, Shape, str, float]


def entries(cfg: dict) -> List[Entry]:
    """Every weight of the configuration but the mean parameters and the
    readouts' zero biases."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    out: List[Entry] = []

    def norm(name, width):
        out.extend([(name + ".weight", (width,), "norm", 0.2),
                    (name + ".bias", (width,), "normal", NORM_BIAS_STD)])

    def enc_linear(name, n_out, n_in):
        out.extend([(name + ".weight", (n_out, n_in), "normal", ENCODER_STD),
                    (name + ".bias", (n_out,), "normal", ENCODER_STD)])

    def dec_linear(name, n_out, n_in, bias=True):
        out.append((name + ".weight", (n_out, n_in), "uniform",
                    n_in ** -0.5))
        if bias:
            out.append((name + ".bias", (n_out,), "uniform", n_in ** -0.5))

    e = "backbone.encoder."
    fan = 3 * p * p
    out.extend([(e + "patch_embed.proj.weight", (d, 3, p, p), "uniform",
                 fan ** -0.5),
                (e + "patch_embed.proj.bias", (d,), "uniform", fan ** -0.5),
                (e + "cls_token", (1, 1, d), "normal", ENCODER_STD),
                (e + "pos_embed", (1, cfg["pos_embed_grid"] ** 2 + 1, d),
                 "normal", ENCODER_STD)])
    for i in range(cfg["depth"]):
        b = f"{e}blocks.{i}."
        norm(b + "norm1", d)
        enc_linear(b + "attn.qkv", 3 * d, d)
        enc_linear(b + "attn.proj", d, d)
        out.append((b + "ls1.gamma", (d,), "layerscale", 0.0))
        norm(b + "norm2", d)
        enc_linear(b + "mlp.fc1", cfg["mlp_dim"], d)
        enc_linear(b + "mlp.fc2", d, cfg["mlp_dim"])
        out.append((b + "ls2.gamma", (d,), "layerscale", 0.0))
    norm(e + "norm", d)

    h = "x_attention_head."
    grid, c = cfg["image_size"] // p, cfg["context_dim"]
    out.extend([(h + "row_embed", (grid, c), "normal", EMBED_STD),
                (h + "col_embed", (grid, c), "normal", EMBED_STD)])
    dec_linear(h + "mlp_offset.0", d, d)
    out.append((h + "mlp_offset.2.weight", (2, d), "readout",
                OFFSET_GAIN / math.sqrt(d)))
    t = h + "transformer."
    dim = cfg["hph_dim"]
    inner = cfg["hph_heads"] * cfg["hph_dim_head"]
    dec_linear(t + "to_token_embedding", dim, cfg["token_dim"])
    out.append((t + "pos_embedding", (1, 1, dim), "normal", 1.0))
    for i in range(cfg["hph_depth"]):
        layer = f"{t}transformer.layers.{i}."
        norm(layer + "0.norm", dim)
        dec_linear(layer + "0.fn.to_qkv", 3 * inner, dim, bias=False)
        dec_linear(layer + "0.fn.to_out.0", dim, inner)
        norm(layer + "1.norm", dim)
        dec_linear(layer + "1.fn.to_kv", 2 * inner, c, bias=False)
        dec_linear(layer + "1.fn.to_q", inner, dim, bias=False)
        dec_linear(layer + "1.fn.to_out.0", dim, inner)
        norm(layer + "2.norm", dim)
        dec_linear(layer + "2.fn.net.0", cfg["hph_mlp_dim"], dim)
        dec_linear(layer + "2.fn.net.3", dim, cfg["hph_mlp_dim"])
    for name, n in readouts(cfg).items():
        gain = (SHAPE_GAIN if name in ("decshape", "decexpression")
                else READOUT_GAIN)
        out.append((f"{h}{name}.weight", (n, dim), "readout",
                    gain / math.sqrt(dim)))
    return out


def readouts(cfg: dict) -> Dict[str, int]:
    return {"decpose": cfg["pose_joints"] * cfg["pose_rep_dim"],
            "decshape": cfg["n_betas"], "deccam": cfg["n_cam"],
            "decexpression": cfg["n_expression"]}


@torch.no_grad()
def mean_params(seed: int, device, cfg: dict) -> torch.Tensor:
    """(6 pose_joints + 10 + 3,) the head's start: a seeded mean pose, zero
    betas, camera (nearness -log(``MEAN_DEPTH``), 0, 0).  Multi-HMR's mean
    parameters are not in the repository.  Each of the predicted joints
    turns about a random axis by about ``MEAN_POSE_RADIANS``; its 6D value
    is its matrix's first two columns read as (3, 2), as the port's
    ``rot6d_to_rotmat`` reads them."""
    gen = seeding.generator(seed, "multihmr.mean_params", device)
    J = cfg["pose_joints"]
    aa = MEAN_POSE_RADIANS * torch.randn((J, 3), generator=gen,
                                         device=device)
    angle = aa.norm(dim=1, keepdim=True)
    k = aa / angle
    K = torch.zeros((J, 3, 3), device=device)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(1, 2)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    R = torch.eye(3, device=device) + s * K + (1 - c) * (K @ K)
    return torch.cat([R[:, :, :2].reshape(-1),
                      torch.zeros(cfg["n_betas"], device=device),
                      torch.tensor([-math.log(MEAN_DEPTH), 0.0, 0.0],
                                   device=device)])


@torch.no_grad()
def make(seed: int, device, cfg: dict,
         mean: torch.Tensor) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``; ``mean``: :func:`mean_params`."""
    gen = seeding.generator(seed, "multihmr_vitl.weights", device)
    table = entries(cfg)
    drawn = {"normal": [e for e in table if e[2] in ("normal", "readout")],
             "uniform": [e for e in table
                         if e[2] in ("uniform", "norm", "layerscale")]}
    w: Dict[str, torch.Tensor] = {}
    lo, hi = LAYERSCALE
    for kind, group in drawn.items():
        sizes = [math.prod(shape) for _, shape, _, _ in group]
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, how, scale), t in zip(group,
                                                torch.split(flat, sizes)):
            t = t.view(shape)
            if how == "layerscale":
                t.mul_(hi - lo).add_(lo)
            elif how in ("uniform", "norm"):
                t.mul_(2).sub_(1).mul_(scale)
                if how == "norm":
                    t.add_(1.0)
            else:
                t.mul_(scale)
                if how == "readout":
                    t.sub_(t.mean(dim=1, keepdim=True))
            w[name] = t
    h = "x_attention_head."
    for name in [*readouts(cfg), "mlp_offset.2"]:
        rows = w[f"{h}{name}.weight"].shape[0]
        w[f"{h}{name}.bias"] = torch.zeros(rows, device=device)
    npose = cfg["pose_joints"] * cfg["pose_rep_dim"]
    mean = mean.to(device).float()
    w[h + "init_body_pose"] = mean[:npose].reshape(1, npose)
    w[h + "init_betas"] = mean[npose:npose + 10].reshape(1, 10)
    w[h + "init_cam"] = mean[npose + 10:npose + 13].reshape(1, 3)
    return w


def served(weights: Dict[str, torch.Tensor],
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights in the type they are served in: the patch convolution
    and every Linear of the encoder and of the head's transformer (weights
    and biases) in ``dtype``; the LayerNorms, LayerScale, the cls token,
    the embeddings, the offset head, the readouts and the mean parameters
    float32.  Each is a tensor of its own: none holds on to the draws
    :func:`make` sliced the weights from."""
    low = ("patch_embed.proj", ".attn.", ".mlp.fc", "to_token_embedding",
           ".fn.to_", ".fn.net.")
    return {k: v.to(dtype) if any(s in k for s in low) else v.clone()
            for k, v in weights.items()}


def parameter_count(cfg: dict) -> int:
    """The encoder's parameters: the patch embedding, cls token, position
    table, blocks and final norm."""
    return sum(math.prod(shape) for name, shape, _, _ in entries(cfg)
               if name.startswith("backbone."))

