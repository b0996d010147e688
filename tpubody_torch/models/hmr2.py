"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023, arXiv:2305.20091): a
ViT-H/16 encoder as ViTPose builds it (Xu et al., arXiv:2204.12484) and a
cross-attention transformer decoder that reads SMPL out of one token, with
the layer equations of 4D-Humans (``hmr2/models/backbones/vit.py``,
``hmr2/models/heads/smpl_head.py``,
``hmr2/models/components/pose_transformer.py``).

Input (B, 256, 256, 3) NHWC normalised images -> ``hmr.HMROutput``
(rotation matrices (B, 24, 3, 3), betas (B, 10), weak-perspective camera
(B, 3), the 6D pose (B, 144)), so ``HMRSMPLStep`` serves it as it serves
HMR.  The model keeps the middle ``crop_width`` columns (32:224 of 256),
embeds 16 x 16 patches with padding 2 (a 16 x 12 grid: 192 tokens), adds
``pos_embed[:, 1:] + pos_embed[:, :1]`` (the class slot goes to every
token), runs 32 pre-norm blocks ``x += attn(LN1(x)); x += mlp(LN2(x))``
(LayerNorm eps 1e-6, 16 heads of 80, GELU) and ``last_norm``.  The decoder
embeds a zero token, adds its position embedding and runs 6 layers ``x +=
SA(LN(x)); x += CA(LN(x), tokens); x += FF(LN(x))`` (LayerNorm eps 1e-5,
8 heads of 64, the cross-attention's keys and values from the 192
encoder tokens).  ``decpose``, ``decshape`` and ``deccam`` add to the mean
parameters in one pass (``IEF_ITERS`` 1), and the 6D pose becomes rotation
matrices.  Every width is a constructor argument; the defaults are the
published ones.

Precision, as ``torch.autocast(dtype=bfloat16)`` computes the published
module, spelled out for a ``dtype`` model (``to_compute``): the patch
convolution, every Linear of the encoder and the decoder and the attention
take operands in ``dtype`` and accumulate in float32; the LayerNorms, their
statistics and the softmax are float32; the residual streams are float32
(the published decoder's in-place ``x += pos_embedding`` would keep its
one-token stream in bf16); the readout and the pose state are float32, as
``HMR.ief`` keeps them.  The encoder's tokens are cast to ``dtype`` once
for the six cross-attentions, which round them the same way each.

The encoder runs each residual add together with the LayerNorm after it
(``norm2``, the next block's ``norm1``, or ``last_norm``) and the cast of
that LayerNorm's output to the next Linear's dtype: one
:func:`add_layernorm` (``csrc/add_layernorm.cu`` on the card), so
``ViTH.forward`` carries the stream and its normalised view from block to
block and the first ``norm1`` alone runs eagerly.

The 6D layout: 4D-Humans reads a joint's 6 numbers as (2, 3), the two
columns one after the other; the port's ``rot6d_to_rotmat`` reads (3, 2).
The head keeps the published parameters and buffers as they are
(``decpose`` and ``init_body_pose`` in 4D-Humans' layout) and reorders the
pose into the port's layout before the rotation matrices, so a 4D-Humans
checkpoint loads by name and ``pose6d`` and ``mean_params`` are in the
layout of the rest of the port.

State-dict names are 4D-Humans' module paths: ``backbone.patch_embed.proj``,
``backbone.pos_embed``, ``backbone.blocks.{i}.{norm1, attn.qkv, attn.proj,
norm2, mlp.fc1, mlp.fc2}``, ``backbone.last_norm``,
``smpl_head.transformer.{to_token_embedding, pos_embedding}``,
``smpl_head.transformer.transformer.layers.{i}.{0, 1, 2}.{norm, fn.*}``,
``smpl_head.{decpose, decshape, deccam}`` and the mean parameters
``smpl_head.{init_body_pose, init_betas, init_cam}``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpubody_torch import native
from tpubody_torch.core.rotations import rot6d_to_rotmat
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.models.hmr import NPOSE, HMROutput, identity_mean_params
from tpubody_torch.utils.profiling import span

N_JOINTS = NPOSE // 6
PATCH_PADDING = 2      # ViTPose's 4 + 2 * (ratio // 2 - 1) at ratio 1
ENCODER_EPS = 1e-6
DECODER_EPS = 1e-5
INIT_STD = 0.02        # ViTPose's truncated normal for the encoder
HEAD_GAIN = 0.01       # the readout's xavier gain, as hmr.init_weights
MEAN_KEYS = ("init_body_pose", "init_betas", "init_cam")
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` with its input rounded to the layer's dtype."""
    return layer(x.to(layer.weight.dtype))


def _heads(x: torch.Tensor, parts: int, heads: int) -> torch.Tensor:
    """(B, N, parts * heads * d) -> (parts, B, heads, N, d), a view."""
    B, N, _ = x.shape
    return x.view(B, N, parts, heads, -1).permute(2, 0, 3, 1, 4)


def _merge(y: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, d) -> (B, N, heads * d)."""
    B, _, N, _ = y.shape
    return y.transpose(1, 2).reshape(B, N, -1)


# -- the encoder: ViT-H/16 as ViTPose builds it -----------------------------
class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int,
                 padding: int = PATCH_PADDING):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size,
                              padding=padding)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, tokens, dim), row-major over the
        grid, in the convolution's dtype."""
        x = self.proj(images.permute(0, 3, 1, 2).to(self.proj.weight.dtype))
        return x.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention, ``heads`` heads of ``dim // heads``.

    A head width that is not a multiple of 8 (Sapiens' 60) is served padded
    to the next multiple of 8: ``qkv`` holds zero output rows after each
    head's q, k and v and ``proj`` zero input columns after each head's, so
    that SDPA sees a width its fused kernels take, the scale passed as the
    published width's.  The zero columns add nothing to Q K^T, and A V's
    zero columns meet zero weights in ``proj``.  The state dict holds the
    published shapes ((3 dim, dim) ``qkv``, (dim, dim) ``proj``) either
    way: the padding is dropped when it is saved and made when it is
    loaded."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.padded = -(-self.head_dim // 8) * 8
        inner = heads * self.padded
        self.qkv = nn.Linear(dim, 3 * inner)
        self.proj = nn.Linear(inner, dim)
        if self.padded != self.head_dim:
            self.register_state_dict_post_hook(_unpad_heads)
            self.register_load_state_dict_pre_hook(_pad_heads)
            self.load_state_dict(self.state_dict())    # zero the padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = _heads(_linear(self.qkv, x), 3, self.heads)
        # SDPA's own default for unpadded heads, the same double
        y = F.scaled_dot_product_attention(
            q, k, v, scale=1.0 / math.sqrt(self.head_dim))
        return _linear(self.proj, _merge(y))


def _unpad_heads(module: Attention, state_dict, prefix: str,
                 local_metadata) -> None:
    """Drop the padding of each head from the saved ``qkv`` and ``proj``."""
    h, d, p = module.heads, module.head_dim, module.padded
    for name in ("qkv.weight", "qkv.bias"):
        t = state_dict[prefix + name]
        state_dict[prefix + name] = t.reshape(
            3, h, p, *t.shape[1:])[:, :, :d].reshape(3 * h * d,
                                                     *t.shape[1:])
    t = state_dict[prefix + "proj.weight"]
    state_dict[prefix + "proj.weight"] = t.reshape(
        len(t), h, p)[:, :, :d].reshape(len(t), h * d)


def _pad_heads(module: Attention, state_dict, prefix: str, *args) -> None:
    """Pad each head of a published ``qkv`` and ``proj`` with zeros."""
    h, d, p = module.heads, module.head_dim, module.padded
    for name in ("qkv.weight", "qkv.bias"):
        t = state_dict.get(prefix + name)
        if t is not None and len(t) == 3 * h * d:
            t = t.reshape(3, h, d, *t.shape[1:])
            state_dict[prefix + name] = F.pad(
                t, [0, 0] * (t.dim() - 3) + [0, p - d]).reshape(
                    3 * h * p, *t.shape[3:])
    t = state_dict.get(prefix + "proj.weight")
    if t is not None and t.shape[-1] == h * d:
        state_dict[prefix + "proj.weight"] = F.pad(
            t.reshape(len(t), h, d), [0, p - d]).reshape(len(t), h * p)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(_linear(self.fc1, x)))


def add_layernorm_reference(x: torch.Tensor, branch: torch.Tensor,
                            norm: nn.LayerNorm, out_dtype: torch.dtype,
                            keep_x: bool = True,
                            scale: Optional[torch.Tensor] = None
                            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The plain version of :func:`add_layernorm`: the eager chain, in its
    order (the add, in float32 by type promotion, after the product with
    ``scale`` where there is one, ``norm``, the cast)."""
    x = x + (branch if scale is None else scale * branch)
    h = norm(x).to(out_dtype)
    return (x if keep_x else None), h


def add_layernorm(x: torch.Tensor, branch: torch.Tensor, norm: nn.LayerNorm,
                  out_dtype: torch.dtype, keep_x: bool = True,
                  scale: Optional[torch.Tensor] = None
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """A residual add and the LayerNorm after it: float32 ``x`` (..., D)
    and ``branch`` (..., D) -> (``x + branch`` float32, or None unless
    ``keep_x``; ``norm`` of it in ``out_dtype``).  The statistics are
    float32.  ``scale``: a float32 per-channel scale (D,) on the branch
    (DINOv2's LayerScale), so that the new stream is ``x + scale *
    branch``.

    On CUDA one launch of ``csrc/add_layernorm.cu``: ``branch`` bf16 or
    float32, ``out_dtype`` bf16 or float32, D a multiple of 8 up to 2048,
    contiguous 16-byte aligned tensors and no autograd.  Its new stream
    has the bits of :func:`add_layernorm_reference`'s, its normalised
    output those of another float32 summation order.  Anything else it
    does not take raises RuntimeError.  The CPU runs
    :func:`add_layernorm_reference`."""
    if x.device.type == "cpu":
        return add_layernorm_reference(x, branch, norm, out_dtype, keep_x,
                                       scale)
    D, dev = x.shape[-1], x.device
    M = x.numel() // max(D, 1)
    if (dev.type != "cuda" or D % 8 or not 8 <= D <= 2048 or M >= 2 ** 31
            or out_dtype not in _KERNEL_DTYPES):
        raise RuntimeError(
            f"add_layernorm takes x (..., D) on CUDA or the CPU, D a multiple "
            f"of 8 up to 2048, and a bf16 or float32 output; got "
            f"{tuple(x.shape)} on {dev}, {out_dtype} output")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, branch, scale, norm.weight, norm.bias)):
        raise RuntimeError("add_layernorm has no backward on CUDA: call it "
                           "under torch.no_grad() or inference mode")
    f32 = (torch.float32,)
    native.expect("x", x, x.shape, f32, dev, aligned=True)
    native.expect("branch", branch, x.shape, _KERNEL_DTYPES, dev, aligned=True)
    if scale is not None:
        native.expect("scale", scale, (D,), f32, dev, aligned=True)
    native.expect("weight", norm.weight, (D,), f32, dev, aligned=True)
    native.expect("bias", norm.bias, (D,), f32, dev, aligned=True)
    x_out = torch.empty_like(x) if keep_x else None
    h = torch.empty(x.shape, dtype=out_dtype, device=dev)
    native.launch("add_layernorm", "tpubody_add_layernorm", dev,
                  x.data_ptr(), branch.data_ptr(),
                  int(branch.dtype == torch.bfloat16),
                  None if scale is None else scale.data_ptr(),
                  norm.weight.data_ptr(),
                  norm.bias.data_ptr(), norm.eps,
                  None if x_out is None else x_out.data_ptr(), h.data_ptr(),
                  int(out_dtype == torch.bfloat16), M, D)
    return x_out, h


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.mlp = Mlp(dim, mlp_dim)


class ViTH(nn.Module):
    """(B, image_size, image_size, 3) NHWC -> (B, tokens, dim) float32
    tokens after ``last_norm``.

    ``cls_pos``: the position table has a class entry first, added to
    every token (ViTPose's, HMR 2.0's); without it (Sapiens') the table
    holds one entry a token.  ``spans``: the prefix of the spans the
    encoder records (``<spans>.backbone``, ``.attention``, ``.mlp``)."""

    def __init__(self, image_size: int = 256, crop_width: int = 192,
                 patch_size: int = 16, dim: int = 1280, depth: int = 32,
                 heads: int = 16, mlp_dim: int = 5120, cls_pos: bool = True,
                 spans: str = "hmr2"):
        super().__init__()
        self.image_size, self.crop_width = image_size, crop_width
        self.cls_pos = cls_pos
        self.spans = {k: f"{spans}.{k}"
                      for k in ("backbone", "attention", "mlp")}
        tokens = (image_size // patch_size) * (crop_width // patch_size)
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + cls_pos, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_dim)
                                    for _ in range(depth))
        self.last_norm = nn.LayerNorm(dim, eps=ENCODER_EPS)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if tuple(images.shape[1:]) != (self.image_size, self.image_size, 3):
            raise ValueError(f"ViTH takes (B, {self.image_size}, "
                             f"{self.image_size}, 3) images, got "
                             f"{tuple(images.shape)}")
        with span(self.spans["backbone"]):
            lo = (self.image_size - self.crop_width) // 2
            x = self.patch_embed(images[:, :, lo:lo + self.crop_width])
            if self.cls_pos:
                x = x + (self.pos_embed[:, 1:] + self.pos_embed[:, :1])
            else:
                x = x + self.pos_embed
            # Each half ends with its residual add and the LayerNorm after
            # it (norm2, the next block's norm1, or last_norm in float32) in
            # one add_layernorm; the last drops the stream.
            first = self.blocks[0]
            h = first.norm1(x).to(first.attn.qkv.weight.dtype)
            for block, nxt in zip(self.blocks, [*self.blocks[1:], None]):
                with span(self.spans["attention"]):
                    x, h = add_layernorm(x, block.attn(h), block.norm2,
                                         block.mlp.fc1.weight.dtype)
                with span(self.spans["mlp"]):
                    if nxt is None:
                        return add_layernorm(x, block.mlp(h), self.last_norm,
                                             torch.float32, keep_x=False)[1]
                    x, h = add_layernorm(x, block.mlp(h), nxt.norm1,
                                         nxt.attn.qkv.weight.dtype)


# -- the SMPL head: 4D-Humans' TransformerDecoder and readout -------------
class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=DECODER_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class SelfAttention(nn.Module):
    """4D-Humans' ``Attention``: ``to_qkv`` without bias, computed in full
    over the decoder's one token."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = _heads(_linear(self.to_qkv, x), 3, self.heads)
        return _linear(self.to_out[0], _merge(
            F.scaled_dot_product_attention(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int,
                 dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = _heads(_linear(self.to_kv, context), 2, self.heads)
        q = _heads(_linear(self.to_q, x), 1, self.heads)[0]
        return _linear(self.to_out[0], _merge(
            F.scaled_dot_product_attention(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x.to(self.net[0].weight.dtype))


class TransformerCrossAttn(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, context_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim))]) for _ in range(depth))


class TransformerDecoder(nn.Module):
    """One token (``num_tokens=1``; HMR 2.0's is a zero token of
    ``token_dim=1``) through ``depth`` layers of self-attention,
    cross-attention to the context and a feed-forward network, pre-norm,
    float32 stream."""

    def __init__(self, dim: int = 1024, depth: int = 6, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 1024,
                 context_dim: int = 1280, token_dim: int = 1):
        super().__init__()
        self.to_token_embedding = nn.Linear(token_dim, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head,
                                                mlp_dim, context_dim)

    def forward(self, token: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        x = _linear(self.to_token_embedding, token) + self.pos_embedding
        for sa, ca, ff in self.transformer.layers:
            x = x + sa(x)
            x = x + ca(x, context=context)
            x = x + ff(x)
        return x


class HMR2Head(nn.Module):
    """4D-Humans' ``SMPLTransformerDecoderHead``: (B, tokens, context_dim)
    encoder tokens -> ``HMROutput``."""

    def __init__(self, mean_params: np.ndarray, dim: int = 1024,
                 depth: int = 6, heads: int = 8, dim_head: int = 64,
                 mlp_dim: int = 1024, context_dim: int = 1280):
        super().__init__()
        self.transformer = TransformerDecoder(dim, depth, heads, dim_head,
                                              mlp_dim, context_dim)
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        mean = torch.as_tensor(np.asarray(mean_params, np.float32))
        pose = mean[:NPOSE].view(N_JOINTS, 3, 2).transpose(1, 2)
        for name, value in zip(MEAN_KEYS, (pose.reshape(1, NPOSE),
                                           mean[NPOSE:NPOSE + 10],
                                           mean[NPOSE + 10:NPOSE + 13])):
            self.register_buffer(name, value.reshape(1, -1).clone())

    def forward(self, tokens: torch.Tensor) -> HMROutput:
        with span("hmr2.head"):
            B = tokens.shape[0]
            dtype = self.transformer.to_token_embedding.weight.dtype
            token = torch.zeros((B, 1, 1), dtype=torch.float32,
                                device=tokens.device)
            h = self.transformer(token, tokens.to(dtype))[:, 0]
            pose = self.decpose(h) + self.init_body_pose
            shape = self.decshape(h) + self.init_betas
            cam = self.deccam(h) + self.init_cam
            pose6d = pose.view(B, N_JOINTS, 2, 3).transpose(2, 3).reshape(
                B, NPOSE)
            rotmats = rot6d_to_rotmat(pose6d.view(B, N_JOINTS, 6))
            return HMROutput(rotmats=rotmats, shape=shape, cam=cam,
                             pose6d=pose6d)


class HMR2(nn.Module):
    """HMR 2.0.  ``mean_params``: (144 + 10 + 3,) the regressor's start,
    the 6D pose in the port's layout (``hmr.identity_mean_params``).

    Inference only on CUDA: the encoder's :func:`add_layernorm` has no
    backward there, and a forward pass that records gradients raises
    RuntimeError (the CPU's eager chain has one)."""

    def __init__(self, mean_params: np.ndarray, image_size: int = 256,
                 crop_width: int = 192, patch_size: int = 16,
                 dim: int = 1280, depth: int = 32, heads: int = 16,
                 mlp_dim: int = 5120, dec_dim: int = 1024,
                 dec_depth: int = 6, dec_heads: int = 8,
                 dec_dim_head: int = 64, dec_mlp_dim: int = 1024):
        super().__init__()
        self.image_size = image_size
        self.backbone = ViTH(image_size, crop_width, patch_size, dim, depth,
                             heads, mlp_dim)
        self.smpl_head = HMR2Head(mean_params, dec_dim, dec_depth,
                                  dec_heads, dec_dim_head, dec_mlp_dim, dim)

    def forward(self, images: torch.Tensor) -> HMROutput:
        """images: (B, image_size, image_size, 3) NHWC, normalised."""
        return self.head(self.backbone(images))

    def head(self, tokens: torch.Tensor) -> HMROutput:
        """The SMPL head on the encoder's tokens (what follows the
        backbone, by the name the serving step calls)."""
        return self.smpl_head(tokens)


# -- weights ----------------------------------------------------------------
@torch.no_grad()
def init_weights(model: HMR2, seed: int = 0) -> None:
    """Seeded initialisation on the CPU generator, so a seed gives the same
    weights on every device: ViTPose's for the encoder (Linears truncated
    normal std 0.02 with zero bias, LayerNorm (1, 0), ``pos_embed``
    truncated normal std 0.02, the patch convolution PyTorch's default),
    PyTorch's defaults for the decoder (``INIT_DECODER_XAVIER`` is off,
    ``pos_embedding`` standard normal), and the readout xavier-uniform
    with gain 0.01 and zero bias, as ``hmr.init_weights`` gives the
    decoders."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def fill(t, draw):
        t.copy_(draw(torch.empty(t.shape, dtype=torch.float32)))

    def default(m):                      # nn.Linear / nn.Conv2d's own init
        fan_in = m.weight[0].numel()
        bound = fan_in ** -0.5
        fill(m.weight, lambda t: nn.init.kaiming_uniform_(
            t, a=5 ** 0.5, generator=gen))
        if m.bias is not None:
            fill(m.bias, lambda t: nn.init.uniform_(t, -bound, bound,
                                                    generator=gen))

    vit = model.backbone
    default(vit.patch_embed.proj)
    fill(vit.pos_embed, lambda t: nn.init.trunc_normal_(t, std=INIT_STD,
                                                        generator=gen))
    for m in vit.modules():
        if isinstance(m, nn.Linear):
            fill(m.weight, lambda t: nn.init.trunc_normal_(
                t, std=INIT_STD, generator=gen))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    head = model.smpl_head
    for m in head.transformer.modules():
        if isinstance(m, nn.Linear):
            default(m)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    fill(head.transformer.pos_embedding,
         lambda t: nn.init.normal_(t, generator=gen))
    for m in (head.decpose, head.decshape, head.deccam):
        fill(m.weight, lambda t: nn.init.xavier_uniform_(
            t, gain=HEAD_GAIN, generator=gen))
        m.bias.zero_()


def to_compute(model: HMR2, dtype: torch.dtype,
               device: torch.device) -> HMR2:
    """Move ``model`` to ``device`` with the patch convolution and every
    Linear of the encoder and the decoder in the compute ``dtype``; the
    LayerNorms, position embeddings, readout and mean parameters stay
    float32.  Eval mode."""
    model.to(device)
    for part in (model.backbone, model.smpl_head.transformer):
        for m in part.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(dtype)
    return model.eval()


def create_hmr2(mean_params: Optional[np.ndarray] = None,
                dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                device: DeviceLike = "cuda", **widths) -> HMR2:
    """HMR 2.0 with seeded random weights (:func:`init_weights`), on
    ``device``, in eval mode.  ``mean_params`` defaults to
    ``hmr.identity_mean_params()``; ``widths`` are :class:`HMR2`'s
    size arguments (tests build tiny instances).  On CUDA the model
    takes no autograd (see :class:`HMR2`): run it under ``torch.no_grad()``
    or inference mode."""
    if mean_params is None:
        mean_params = identity_mean_params()
    model = HMR2(mean_params, **widths)
    init_weights(model, seed)
    return to_compute(model, dtype, resolve(device))


def load_reference_state_dict(model: HMR2, state_dict) -> HMR2:
    """Load 4D-Humans' weights ``{name: array}`` into ``model`` by name:
    the entries under ``backbone.`` and ``smpl_head.`` (a checkpoint's
    other modules, such as its discriminator, are not read).  The mean
    parameters ``smpl_head.init_*`` may be absent; the model then keeps
    those it was built with.  Each tensor is copied into the model's own,
    on its device and in its dtype."""
    sd = {k: (v.detach() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v)))
          for k, v in state_dict.items()
          if k.split(".")[0] in ("backbone", "smpl_head")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing
               if k not in {"smpl_head." + n for n in MEAN_KEYS}]
    if missing or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model
