"""Plain PyTorch reference of Multi-HMR + SMPL-X: images -> (posed vertices,
translation) of each given person.

The model as the configuration states it (Baradel et al. 2024,
arXiv:2402.14654, with DINOv2's ViT-L/14, Oquab et al. 2023,
arXiv:2304.07193, and SMPL-X, Pavlakos et al. 2019):

* the (B, S, S, 3) images through a ``patch_size`` convolution without
  padding, a cls token first, plus ``pos_embed`` with its grid part
  resized to the image's grid (bicubic, ``align_corners=False``);
* ``depth`` blocks ``x += ls1 * proj(attn(qkv(LN1(x))))``, then ``x +=
  ls2 * fc2(GELU(fc1(LN2(x))))`` (LayerNorm eps 1e-6, ``num_heads``
  heads), then ``norm``; the patch tokens are kept;
* each patch token ⊕ the Fourier encoding of its camera ray ``K^-1 [u, v,
  1]`` (``[d, sin(pi f d), cos(pi f d)]``, ``f = linspace(1,
  ray_max_resolution / 2, ray_bands)``), plus its row's and column's
  embeddings;
* a person's query: its centre context token ⊕ ``init_body_pose``,
  ``init_betas``, ``init_cam``, through ``to_token_embedding`` plus
  ``pos_embedding``; ``hph_depth`` layers ``x += SA(LN(x)); x += CA(LN(x),
  context); x += FF(LN(x))`` (LayerNorm eps 1e-5; SA over the one query;
  the keys and values of CA projected from the image's context once, for
  all its persons);
* ``decpose``, ``decshape``, ``deccam`` added to the mean values,
  ``decexpression`` from zero; 6D rotations read as (3, 2) and
  Gram-Schmidt, the eyes the identity; the sub-patch offset from
  ``mlp_offset`` on the centre's encoder token;
* SMPL-X by linear blend skinning with betas ⊕ expression on shapedirs ⊕
  expr_dirs; the translation puts the posed ``anchor_joint`` at
  ``exp(-nearness) K^-1 [u, v, 1]``, (u, v) the patch centre plus
  ``patch_size`` x the offset, the nearness the camera's first value.

Attention is written out as ``softmax(Q K^T * scale) V``.  Everything is
float32 with TF32 off, computed ``block`` frames at a time (one image's
attention scores are 1.07 GB).  It reads only the weights (DINOv2's and
Multi-HMR's names, ``benchmark/models/multihmr_vitl.py``), body and images
the benchmark made; it imports nothing of the program.

``operand`` rounds each operand of the patch convolution and of every
Linear of the encoder and of the head's transformer: the identity for the
reference, ``hmr_smpl.fp8`` for the control.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import hmr_smpl
from benchmark.reference.hmr2_smpl import (DECODER_EPS, ENCODER_EPS,
                                           attention, heads, layer_norm,
                                           linear)
from benchmark.reference.hmr_smpl import Operand, exact

Weights = Dict[str, torch.Tensor]
ENC = "backbone.encoder."
HEAD = "x_attention_head."


def position_table(w: Weights, cfg: dict) -> torch.Tensor:
    """``pos_embed`` (1, 1 + g^2, D) -> (1, 1 + grid^2, D): the grid part
    resized bicubically, the cls entry first."""
    pos = w[ENC + "pos_embed"].float()
    g, D = cfg["pos_embed_grid"], pos.shape[-1]
    grid = cfg["image_size"] // cfg["patch_size"]
    part = F.interpolate(pos[:, 1:].reshape(1, g, g, D).permute(0, 3, 1, 2),
                         size=(grid, grid), mode="bicubic",
                         align_corners=False)
    return torch.cat([pos[:, :1], part.flatten(2).transpose(1, 2)], dim=1)


def vit(w: Weights, images: torch.Tensor, cfg: dict,
        operand: Operand = exact) -> torch.Tensor:
    """(B, S, S, 3) NHWC images -> (B, grid^2, embed_dim) patch tokens
    after ``norm``."""
    x = F.conv2d(operand(images.permute(0, 3, 1, 2).float()),
                 operand(w[ENC + "patch_embed.proj.weight"].float()),
                 w[ENC + "patch_embed.proj.bias"].float(),
                 stride=cfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    cls = w[ENC + "cls_token"].float().expand(len(x), -1, -1)
    x = torch.cat([cls, x], dim=1) + position_table(w, cfg)
    for i in range(cfg["depth"]):
        b = f"{ENC}blocks.{i}."
        h = layer_norm(w, b + "norm1", x, ENCODER_EPS)
        q, k, v = (heads(t, cfg["num_heads"]) for t in
                   linear(w, b + "attn.qkv", h, operand).chunk(3, dim=-1))
        y = linear(w, b + "attn.proj", attention(q, k, v), operand)
        x = x + w[b + "ls1.gamma"].float() * y
        h = layer_norm(w, b + "norm2", x, ENCODER_EPS)
        y = linear(w, b + "mlp.fc2",
                   F.gelu(linear(w, b + "mlp.fc1", h, operand)), operand)
        x = x + w[b + "ls2.gamma"].float() * y
    return layer_norm(w, ENC + "norm", x, ENCODER_EPS)[:, 1:]


def focal(cfg: dict) -> float:
    half = torch.deg2rad(torch.tensor(cfg["fov_deg"],
                                      dtype=torch.float64)) / 2
    return cfg["image_size"] / 2 / float(torch.tan(half))


def ray(u: torch.Tensor, v: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``K^-1 [u, v, 1]`` for pixel coordinates -> (..., 3)."""
    c, f = cfg["image_size"] / 2, focal(cfg)
    return torch.stack([(u - c) / f, (v - c) / f, torch.ones_like(u)], -1)


def ray_features(cfg: dict, device) -> torch.Tensor:
    """(grid^2, 3 + 6 ray_bands) the Fourier encoding of each patch
    centre's ray, the patches row-major."""
    grid = cfg["image_size"] // cfg["patch_size"]
    idx = torch.arange(grid * grid, device=device, dtype=torch.float64)
    row = torch.div(idx, grid, rounding_mode="floor")
    col = idx - row * grid
    d = ray((col + 0.5) * cfg["patch_size"], (row + 0.5) * cfg["patch_size"],
            cfg)
    freq = torch.linspace(1.0, cfg["ray_max_resolution"] / 2,
                          cfg["ray_bands"], dtype=torch.float64,
                          device=device)
    sines = [torch.sin(torch.pi * d[:, i:i + 1] * freq) for i in range(3)]
    cosines = [torch.cos(torch.pi * d[:, i:i + 1] * freq) for i in range(3)]
    return torch.cat([d, *sines, *cosines], dim=1).float()


def context(w: Weights, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Patch tokens (B, N, D) -> the head's context (B, N, context_dim)."""
    B, N, _ = tokens.shape
    rays = ray_features(cfg, tokens.device).expand(B, -1, -1)
    grid = cfg["image_size"] // cfg["patch_size"]
    pos = (w[HEAD + "row_embed"].float()[:, None]
           + w[HEAD + "col_embed"].float()[None]).reshape(grid * grid, -1)
    return torch.cat([tokens, rays], dim=-1) + pos


def decoder(w: Weights, query: torch.Tensor, ctx: torch.Tensor, cfg: dict,
            operand: Operand = exact) -> torch.Tensor:
    """Queries (B, P, token_dim), the images' contexts (B, N, C) -> the
    decoder's tokens (B, P, hph_dim): each query alone in self-attention,
    each attending to its own image's context."""
    t = HEAD + "transformer."
    n_heads = cfg["hph_heads"]
    B, P, _ = query.shape
    x = (linear(w, t + "to_token_embedding", query, operand)
         + w[t + "pos_embedding"].float())
    for i in range(cfg["hph_depth"]):
        layer = f"{t}transformer.layers.{i}."
        h = layer_norm(w, layer + "0.norm", x, DECODER_EPS).reshape(
            B * P, 1, -1)
        q, k, v = (heads(u, n_heads) for u in linear(
            w, layer + "0.fn.to_qkv", h, operand, bias=False).chunk(3, -1))
        x = x + linear(w, layer + "0.fn.to_out.0", attention(q, k, v),
                       operand).reshape(B, P, -1)
        h = layer_norm(w, layer + "1.norm", x, DECODER_EPS)
        k, v = (heads(u, n_heads) for u in linear(
            w, layer + "1.fn.to_kv", ctx, operand, bias=False).chunk(2, -1))
        q = heads(linear(w, layer + "1.fn.to_q", h, operand, bias=False),
                  n_heads)
        x = x + linear(w, layer + "1.fn.to_out.0", attention(q, k, v),
                       operand)
        h = layer_norm(w, layer + "2.norm", x, DECODER_EPS)
        h = F.gelu(linear(w, layer + "2.fn.net.0", h, operand))
        x = x + linear(w, layer + "2.fn.net.3", h, operand)
    return x


def dense(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[name + ".weight"].float(), w[name + ".bias"].float())


def regress(w: Weights, images: torch.Tensor, centres: torch.Tensor,
            cfg: dict, operand: Operand = exact):
    """Images (B, ...) and centres (B, P) -> (rotation matrices (B, P, 55,
    3, 3), betas ⊕ expression (B, P, 20), the head joint's place (B, P,
    3))."""
    tokens = vit(w, images, cfg, operand)
    ctx = context(w, tokens, cfg)
    B, P = centres.shape
    at = centres.to(tokens.device).long()
    pick = at[..., None].expand(B, P, ctx.shape[-1])
    mean = [w[HEAD + k].float().expand(B, P, -1)
            for k in ("init_body_pose", "init_betas", "init_cam")]
    query = torch.cat([torch.gather(ctx, 1, pick), *mean], dim=-1)
    h = decoder(w, query, ctx, cfg, operand)
    pose = dense(w, HEAD + "decpose", h) + mean[0]
    betas = dense(w, HEAD + "decshape", h) + mean[1]
    cam = dense(w, HEAD + "deccam", h) + mean[2]
    expression = dense(w, HEAD + "decexpression", h)
    centre = torch.gather(tokens, 1, at[..., None].expand(
        B, P, tokens.shape[-1]))
    offset = dense(w, HEAD + "mlp_offset.2", torch.relu(
        dense(w, HEAD + "mlp_offset.0", centre)))
    rot = hmr_smpl.rot6d_to_rotmat(pose.reshape(B, P, -1, 6))
    eye = torch.eye(3, device=rot.device).expand(B, P, 2, 3, 3)
    rotmats = torch.cat([rot[:, :, :23], eye, rot[:, :, 23:]], dim=2)
    grid = cfg["image_size"] // cfg["patch_size"]
    row = torch.div(at, grid, rounding_mode="floor").float()
    col = (at - row.long() * grid).float()
    u = (col + 0.5 + offset[..., 0]) * cfg["patch_size"]
    v = (row + 0.5 + offset[..., 1]) * cfg["patch_size"]
    place = torch.exp(-cam[..., :1]) * ray(u, v, cfg)
    return rotmats, torch.cat([betas, expression], dim=-1), place


def smplx(body: Dict[str, torch.Tensor], parents: Sequence[int],
          rotmats: torch.Tensor, coeffs: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMPL-X's linear blend skinning with no translation: (B, J, 3, 3)
    rotations, (B, S + E) betas ⊕ expression -> (posed vertices (B, V, 3),
    posed joints (B, J, 3))."""
    B, J = rotmats.shape[:2]
    basis = torch.cat([body["shapedirs"], body["expr_dirs"]], dim=-1)
    v_shaped = body["v_template"] + torch.einsum("vcs,bs->bvc", basis,
                                                 coeffs)
    joints = torch.einsum("jv,bvc->bjc", body["j_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", body["posedirs"],
                                      pose_feature)
    world_R, world_t = [rotmats[:, 0]], [joints[:, 0]]
    for i in range(1, J):
        p = parents[i]
        world_R.append(world_R[p] @ rotmats[:, i])
        world_t.append(world_t[p] + (world_R[p] @ (joints[:, i] - joints[:, p])
                                     [..., None])[..., 0])
    R = torch.stack(world_R, dim=1)
    posed = torch.stack(world_t, dim=1)
    t = posed - (R @ joints[..., None])[..., 0]
    A = torch.cat([R, t[..., None]], dim=-1)
    T = torch.einsum("vj,bjrc->bvrc", body["weights"], A)
    verts = (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]
    return verts, posed


@torch.no_grad()
def forward(weights: Weights, body: Dict[str, torch.Tensor], parents,
            images: torch.Tensor, cfg: dict, operand: Operand = exact,
            block: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (N, S, S, 3) -> (vertices (N, P, V, 3), translation (N, P,
    3)) of the configuration's ``centres``, float32, ``block`` frames at a
    time."""
    centres = torch.as_tensor(cfg["centres"], device=images.device)
    verts, transl = [], []
    with hmr_smpl.no_tf32():
        for s in range(0, images.shape[0], block):
            part = images[s:s + block]
            rotmats, coeffs, place = regress(
                weights, part, centres.expand(len(part), -1), cfg, operand)
            B, P = place.shape[:2]
            v, joints = smplx(body, parents, rotmats.flatten(0, 1),
                              coeffs.flatten(0, 1))
            t = place.reshape(B * P, 3) - joints[:, cfg["anchor_joint"]]
            verts.append((v + t[:, None]).reshape(B, P, -1, 3))
            transl.append(t.reshape(B, P, 3))
    return torch.cat(verts), torch.cat(transl)
