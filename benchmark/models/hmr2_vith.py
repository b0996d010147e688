"""Seeded weights of HMR 2.0 (ViT-H/16 encoder, transformer decoder,
readout), made on the device, under 4D-Humans' names
(``backbone.patch_embed.proj``, ``backbone.blocks.{i}.attn.qkv``, ...,
``smpl_head.transformer.transformer.layers.{i}.{0,1,2}``,
``smpl_head.decpose``, ``smpl_head.init_body_pose``).  Trained weights are
not in the repository; these stand in for them at the same shapes, close to
the published initialisations, so that activations keep their scale through
the 32 blocks and different images give clearly different poses:

* the encoder's Linears N(0, 0.02^2) (ViTPose's truncated normal, whose
  cut at +-2 does nothing at this std), their biases N(0, 0.02^2) where
  ViTPose starts from zero, so that a dropped bias shows; the patch
  convolution and its bias U(+-1/sqrt(768)), PyTorch's default;
  ``pos_embed`` N(0, 0.02^2);
* every LayerNorm's scale U(0.8, 1.2) and bias N(0, 0.02^2) where the
  published models start from (1, 0), so that a swap of the two shows;
* the decoder's Linears and biases U(+-1/sqrt(fan_in)), PyTorch's default
  (4D-Humans' ``INIT_DECODER_XAVIER`` is off; ``to_token_embedding`` has a
  fan-in of 1), ``pos_embedding`` N(0, 1) as 4D-Humans draws it;
* ``decpose``, ``decshape`` and ``deccam`` normal with std
  ``READOUT_GAIN / sqrt(dim)`` less each row's mean, bias 0, as
  ``hmr_r50`` makes its decoders;
* ``init_body_pose``, ``init_betas`` and ``init_cam``: the benchmark's
  mean parameters, the 6D pose in 4D-Humans' layout (each joint's two
  columns one after the other).

All values come from two generator calls on the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import seeding
from benchmark.models import vit_flops

READOUT_GAIN = 0.03
ENCODER_STD = 0.02
NORM_BIAS_STD = 0.02
Shape = Tuple[int, ...]
# (name, shape, draw, scale): "normal" is N(0, scale^2), "uniform"
# U(-scale, scale), "norm" a LayerNorm scale 1 + U(-scale, scale).
Entry = Tuple[str, Shape, str, float]


def entries(cfg: dict) -> List[Entry]:
    """Every weight of the configuration but the mean parameters."""
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

    fan = 3 * p * p
    out.extend([("backbone.patch_embed.proj.weight", (d, 3, p, p),
                 "uniform", fan ** -0.5),
                ("backbone.patch_embed.proj.bias", (d,), "uniform",
                 fan ** -0.5)])
    out.append(("backbone.pos_embed", (1, vit_flops.grid(cfg) + 1, d),
                "normal", ENCODER_STD))
    for i in range(cfg["depth"]):
        b = f"backbone.blocks.{i}."
        norm(b + "norm1", d)
        enc_linear(b + "attn.qkv", 3 * d, d)
        enc_linear(b + "attn.proj", d, d)
        norm(b + "norm2", d)
        enc_linear(b + "mlp.fc1", cfg["mlp_dim"], d)
        enc_linear(b + "mlp.fc2", d, cfg["mlp_dim"])
    norm("backbone.last_norm", d)

    t = "smpl_head.transformer."
    dim = cfg["decoder_dim"]
    inner = cfg["decoder_heads"] * cfg["decoder_dim_head"]
    dec_linear(t + "to_token_embedding", dim, cfg["token_dim"])
    out.append((t + "pos_embedding", (1, 1, dim), "normal", 1.0))
    for i in range(cfg["decoder_depth"]):
        layer = f"{t}transformer.layers.{i}."
        norm(layer + "0.norm", dim)
        dec_linear(layer + "0.fn.to_qkv", 3 * inner, dim, bias=False)
        dec_linear(layer + "0.fn.to_out.0", dim, inner)
        norm(layer + "1.norm", dim)
        dec_linear(layer + "1.fn.to_kv", 2 * inner, cfg["context_dim"],
                   bias=False)
        dec_linear(layer + "1.fn.to_q", inner, dim, bias=False)
        dec_linear(layer + "1.fn.to_out.0", dim, inner)
        norm(layer + "2.norm", dim)
        dec_linear(layer + "2.fn.net.0", cfg["decoder_mlp_dim"], dim)
        dec_linear(layer + "2.fn.net.3", dim, cfg["decoder_mlp_dim"])
    npose = cfg["pose_joints"] * cfg["pose_rep_dim"]
    for name, n in (("decpose", npose), ("decshape", cfg["n_betas"]),
                    ("deccam", cfg["n_cam"])):
        out.append((f"smpl_head.{name}.weight", (n, dim), "readout",
                    READOUT_GAIN / math.sqrt(dim)))
    return out


def mean_4dhumans(mean: torch.Tensor, pose_joints: int = 24
                  ) -> Dict[str, torch.Tensor]:
    """(157,) mean parameters, each joint's 6D pose read as (3, 2) (the
    benchmark's and the port's layout) -> 4D-Humans' ``init_body_pose``
    (1, 144) in its (2, 3) layout, ``init_betas`` (1, 10), ``init_cam``
    (1, 3)."""
    npose = 6 * pose_joints
    pose = mean[:npose].reshape(pose_joints, 3, 2).transpose(1, 2)
    return {"smpl_head.init_body_pose": pose.reshape(1, npose).contiguous(),
            "smpl_head.init_betas": mean[npose:npose + 10].reshape(1, 10),
            "smpl_head.init_cam": mean[npose + 10:npose + 13].reshape(1, 3)}


@torch.no_grad()
def make(seed: int, device, cfg: dict,
         mean: torch.Tensor) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``; ``mean``: the (157,) mean
    parameters in the benchmark's layout."""
    gen = seeding.generator(seed, "hmr2_vith.weights", device)
    table = entries(cfg)
    drawn = {"normal": [e for e in table if e[2] in ("normal", "readout")],
             "uniform": [e for e in table if e[2] in ("uniform", "norm")]}
    w: Dict[str, torch.Tensor] = {}
    for kind, group in drawn.items():
        sizes = [math.prod(shape) for _, shape, _, _ in group]
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, how, scale), t in zip(group,
                                                torch.split(flat, sizes)):
            t = t.view(shape)
            if how in ("uniform", "norm"):
                t.mul_(2).sub_(1).mul_(scale)
                if how == "norm":
                    t.add_(1.0)
            else:
                t.mul_(scale)
                if how == "readout":
                    t.sub_(t.mean(dim=1, keepdim=True))
            w[name] = t
    for name in ("decpose", "decshape", "deccam"):
        rows = w[f"smpl_head.{name}.weight"].shape[0]
        w[f"smpl_head.{name}.bias"] = torch.zeros(rows, device=device)
    w.update(mean_4dhumans(mean.to(device).float(), cfg["pose_joints"]))
    return w


def served(weights: Dict[str, torch.Tensor],
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights in the type they are served in: the patch convolution
    and every Linear of the encoder and the decoder (weights and biases)
    in ``dtype``; the LayerNorms, position embeddings, readout and mean
    parameters float32.  Each is a tensor of its own: none holds on to
    the draws :func:`make` sliced the weights from."""
    f32 = ("norm", "pos_embed", "smpl_head.dec", "smpl_head.init_")
    return {k: v.clone() if any(s in k for s in f32) else v.to(dtype)
            for k, v in weights.items()}
