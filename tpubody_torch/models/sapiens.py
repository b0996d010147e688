"""Sapiens-2B pose (Khirodkar et al., "Sapiens: Foundation for Human Vision
Models", ECCV 2024, arXiv:2408.12569; github.com/facebookresearch/sapiens):
a 2.2 B-parameter ViT over a 1024 x 768 person crop and mmpose's
deconvolution ``HeatmapHead`` for Goliath's 308 whole-body keypoints.

Input (B, 1024, 1024, 3) NHWC normalised frames -> (B, 256, 192, 308) NHWC
heatmap logits of the frame's middle 768 columns, the contract of
``pose2d.Pose2D.forward``, so ``pose2d.detect`` and ``pose2d.soft_argmax``
read them unchanged (their keypoints are in the crop's pixels);
:meth:`SapiensPose.decode` gives keypoints in the frame's pixels and their
confidences by ``pose2d.soft_argmax_decode``, the same soft-argmax in one
pass over the logits on CUDA (``csrc/soft_argmax.cu``).

The encoder is mmpretrain's ``VisionTransformer`` at Sapiens' ``sapiens_2b``
widths, which is ViTPose's lineage: ``hmr2.ViTH`` with a position table of
one entry a token (no cls token) and spans of its own (``sapiens.backbone``,
``sapiens.attention``, ``sapiens.mlp``).  ``Conv2d(3, 1920, 16, stride 16,
padding 2)`` gives a 64 x 48 grid of 3,072 tokens; 48 pre-norm blocks ``x
+= proj(attn(qkv(LN1(x))))``, ``x += fc2(GELU(fc1(LN2(x))))`` (LayerNorm
eps 1e-6, 32 heads of 60, MLP 7,680, no LayerScale), then the final
LayerNorm.  Heads of 60 are served padded to 64 (``hmr2.Attention``).

The head (:class:`HeatmapHead`): the tokens as a (1920, 64, 48) map, two
``ConvTranspose2d(k=4, s=2, p=1)`` -> BatchNorm -> ReLU (1920 -> 768 ->
768, up to 256 x 192), two 1 x 1 ``Conv2d`` -> BatchNorm -> ReLU, then
``Conv2d(768, 308, 1)``.  BatchNorm (eps 1e-5) is folded into each
convolution's weight and bias when the weights are loaded
(:func:`load_reference_state_dict`), for inference.

Precision, as HMR 2.0's encoder (``models/hmr2.py``): the patch convolution
and every Linear take ``dtype`` operands and accumulate in float32; the
LayerNorms, the softmax and the residual stream are float32.  The head's
convolutions take ``dtype`` operands in channels-last and write ``dtype``;
the final 1 x 1 convolution sums in float32 and writes float32 logits (its
bias float32); the decode is float32, inference only on CUDA.

State-dict names, unconfirmed against a released checkpoint, are
mmpretrain's and mmpose's: ``backbone.patch_embed.projection``,
``backbone.pos_embed``, ``backbone.layers.{i}.{ln1, attn.qkv, attn.proj,
ln2, ffn.layers.0.0, ffn.layers.1}``, ``backbone.ln1`` (the final norm),
``head.deconv_layers.{0, 3}`` (the deconvolutions) and ``{1, 4}`` (their
BatchNorms), ``head.conv_layers.{0, 3}`` and ``{1, 4}``,
``head.final_layer``.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.models import hmr2, pose2d
from tpubody_torch.utils.profiling import span

N_KEYPOINTS = 308       # Goliath's whole-body keypoints
BN_EPS = 1e-5
HEAD_INIT_STD = 0.001   # mmpose's HeatmapHead: Normal(std=0.001) convolutions
PATCH_PADDING = hmr2.PATCH_PADDING
# mmpretrain's encoder names -> hmr2.ViTH's, as (pattern, replacement).
_BACKBONE_NAMES = (
    (r"^backbone\.patch_embed\.projection\.", "backbone.patch_embed.proj."),
    (r"^backbone\.layers\.(\d+)\.ln1\.", r"backbone.blocks.\1.norm1."),
    (r"^backbone\.layers\.(\d+)\.ln2\.", r"backbone.blocks.\1.norm2."),
    (r"^backbone\.layers\.(\d+)\.attn\.", r"backbone.blocks.\1.attn."),
    (r"^backbone\.layers\.(\d+)\.ffn\.layers\.0\.0\.",
     r"backbone.blocks.\1.mlp.fc1."),
    (r"^backbone\.layers\.(\d+)\.ffn\.layers\.1\.",
     r"backbone.blocks.\1.mlp.fc2."),
    (r"^backbone\.ln1\.", "backbone.last_norm."),
)
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _grid(size: int, patch_size: int) -> int:
    """The patch convolution's output length over ``size`` pixels."""
    return (size + 2 * PATCH_PADDING - patch_size) // patch_size + 1


class HeatmapHead(nn.Module):
    """mmpose's ``HeatmapHead`` with its BatchNorms folded: (B, h w, dim)
    float32 tokens, row-major over the ``grid`` (h, w) -> (B, 4 h, 4 w,
    keypoints) float32 NHWC logits."""

    def __init__(self, grid: Tuple[int, int], dim: int = 1920,
                 deconv: Sequence[int] = (768, 768),
                 conv: Sequence[int] = (768, 768),
                 keypoints: int = N_KEYPOINTS):
        super().__init__()
        self.grid = tuple(grid)
        widths = [dim, *deconv]
        self.deconv = nn.ModuleList(
            nn.ConvTranspose2d(a, b, 4, stride=2, padding=1)
            for a, b in zip(widths, widths[1:]))
        widths = [widths[-1], *conv]
        self.conv = nn.ModuleList(nn.Conv2d(a, b, 1)
                                  for a, b in zip(widths, widths[1:]))
        self.final_layer = nn.Conv2d(widths[-1], keypoints, 1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        with span("sapiens.head"):
            h, w = self.grid
            # (B, h w, dim) row-major is (B, dim, h, w) in channels-last.
            x = tokens.view(len(tokens), h, w, -1).permute(0, 3, 1, 2)
            x = x.to(self.deconv[0].weight.dtype)
            for layer in (*self.deconv, *self.conv):
                x = torch.relu_(layer(x))
            return _pointwise_float32(self.final_layer, x)


def _pointwise_float32(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1 x 1 convolution of (B, C, H, W) ``x`` with ``layer``'s weight
    dtype operands, float32 sums and bias -> (B, H, W, O) float32."""
    B, C, H, W = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(-1, C)       # a view in channels-last
    weight = layer.weight.reshape(len(layer.weight), C)
    if rows.is_cuda and rows.dtype != torch.float32:
        out = torch.mm(rows, weight.t(), out_dtype=torch.float32)
    else:
        out = rows.float() @ weight.float().t()
    return out.add_(layer.bias.float()).view(B, H, W, -1)


class SapiensPose(nn.Module):
    """Sapiens pose: images (B, image_size, image_size, 3) NHWC, normalised
    -> heatmap logits (B, 4 h, 4 w, keypoints) of the middle ``crop_width``
    columns (h x w the patch grid).  Every width is a constructor argument;
    the defaults are Sapiens-2B's on Goliath.

    Inference only on CUDA: the encoder's ``hmr2.add_layernorm`` and the
    decode's ``pose2d.soft_argmax_decode`` have no backward there."""

    def __init__(self, image_size: int = 1024, crop_width: int = 768,
                 patch_size: int = 16, dim: int = 1920, depth: int = 48,
                 heads: int = 32, mlp_dim: int = 7680,
                 deconv: Sequence[int] = (768, 768),
                 conv: Sequence[int] = (768, 768),
                 keypoints: int = N_KEYPOINTS):
        super().__init__()
        grid = (_grid(image_size, patch_size), _grid(crop_width, patch_size))
        if grid != (image_size // patch_size, crop_width // patch_size) or \
                patch_size % 4:
            raise ValueError(f"image {image_size} x {crop_width}: a whole "
                             f"number of {patch_size}-pixel patches, and "
                             f"heatmap pixels (a quarter of a patch) of "
                             f"whole pixels")
        self.image_size, self.crop_width = image_size, crop_width
        self.stride = patch_size // 4              # a heatmap pixel's pixels
        self.backbone = hmr2.ViTH(image_size, crop_width, patch_size, dim,
                                  depth, heads, mlp_dim, cls_pos=False,
                                  spans="sapiens")
        self.head = HeatmapHead(grid, dim, deconv, conv, keypoints)
        self.register_buffer("offset", torch.tensor(
            [(image_size - crop_width) // 2, 0], dtype=torch.float32),
            persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(images))

    def decode(self, logits: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logits (B, H, W, K) -> (keypoints (B, K, 2) in the frame's
        pixels, confidences (B, K)), float32: ``pose2d.soft_argmax_decode``
        (the expectation under each keypoint's spatial softmax, its peak
        probability as the confidence; on CUDA ``csrc/soft_argmax.cu``,
        which reads the logits once, on the CPU ``pose2d.soft_argmax``),
        shifted by the crop's offset."""
        with span("sapiens.decode"):
            kp = pose2d.soft_argmax_decode(logits, self.stride)
            return kp[..., :2] + self.offset, kp[..., 2]


# -- weights ----------------------------------------------------------------
def published_names(model: SapiensPose) -> Dict[str, Tuple[int, ...]]:
    """Sapiens' state-dict names and shapes of ``model`` (the unfolded
    head's BatchNorms among them)."""
    vit = model.backbone
    d = vit.pos_embed.shape[-1]
    out = {"backbone.patch_embed.projection.weight":
           tuple(vit.patch_embed.proj.weight.shape),
           "backbone.patch_embed.projection.bias": (d,),
           "backbone.pos_embed": tuple(vit.pos_embed.shape),
           "backbone.ln1.weight": (d,), "backbone.ln1.bias": (d,)}
    for i, block in enumerate(vit.blocks):
        b = f"backbone.layers.{i}."
        hidden = block.mlp.fc1.out_features
        out.update({b + "ln1.weight": (d,), b + "ln1.bias": (d,),
                    b + "attn.qkv.weight": (3 * d, d),
                    b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d),
                    b + "attn.proj.bias": (d,),
                    b + "ln2.weight": (d,), b + "ln2.bias": (d,),
                    b + "ffn.layers.0.0.weight": (hidden, d),
                    b + "ffn.layers.0.0.bias": (hidden,),
                    b + "ffn.layers.1.weight": (d, hidden),
                    b + "ffn.layers.1.bias": (d,)})
    head = model.head
    for group, layers in (("deconv_layers", head.deconv),
                          ("conv_layers", head.conv)):
        for j, layer in enumerate(layers):
            c_out = layer.out_channels
            out[f"head.{group}.{3 * j}.weight"] = tuple(layer.weight.shape)
            if group == "conv_layers":
                out[f"head.{group}.{3 * j}.bias"] = (c_out,)
            for k in _BN_KEYS:
                out[f"head.{group}.{3 * j + 1}.{k}"] = (c_out,)
    out["head.final_layer.weight"] = tuple(head.final_layer.weight.shape)
    out["head.final_layer.bias"] = (head.final_layer.out_channels,)
    return out


@torch.no_grad()
def init_weights(model: SapiensPose, seed: int = 0) -> None:
    """Seeded initialisation on the CPU generator, loaded through
    :func:`load_reference_state_dict`: mmpretrain's for the encoder
    (Linears truncated normal std 0.02 with zero bias, ``pos_embed``
    truncated normal std 0.02, LayerNorm (1, 0), the patch convolution
    PyTorch's default) and mmpose's for the head (convolutions normal std
    0.001 with zero bias, BatchNorm (1, 0) over mean 0 and variance 1)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    fan = 3 * model.backbone.patch_embed.proj.kernel_size[0] ** 2
    sd = {}
    for name, shape in published_names(model).items():
        t = torch.zeros(shape)
        if name.startswith("backbone.patch_embed."):
            nn.init.uniform_(t, -fan ** -0.5, fan ** -0.5, generator=gen)
        elif name == "backbone.pos_embed" or t.dim() == 2:
            nn.init.trunc_normal_(t, std=hmr2.INIT_STD, generator=gen)
        elif t.dim() == 4:
            nn.init.normal_(t, std=HEAD_INIT_STD, generator=gen)
        elif re.search(r"(ln\d|_layers\.\d+)\.weight$|running_var$", name):
            t.fill_(1.0)                       # LayerNorm, BatchNorm scales
        sd[name] = t
    load_reference_state_dict(model, sd)


def to_compute(model: SapiensPose, dtype: torch.dtype,
               device: torch.device) -> SapiensPose:
    """Move ``model`` to ``device`` with the patch convolution, every
    Linear and the head's convolutions in the compute ``dtype`` (the
    head's in channels-last), the final convolution's bias float32; the
    LayerNorms and the position table stay float32.  Eval mode."""
    model.to(device)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            m.to(dtype)
    head = model.head
    for m in (*head.deconv, *head.conv, head.final_layer):
        m.to(memory_format=torch.channels_last)
    head.final_layer.bias.data = head.final_layer.bias.data.float()
    return model.eval()


def create_sapiens_pose(dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        device: DeviceLike = "cuda",
                        **widths) -> SapiensPose:
    """Sapiens pose with seeded random weights (:func:`init_weights`), on
    ``device``, in eval mode; ``widths`` are :class:`SapiensPose`'s size
    arguments (tests build tiny instances).  On CUDA the model takes no
    autograd: run it under ``torch.no_grad()`` or inference mode."""
    model = to_compute(SapiensPose(**widths), dtype, resolve(device))
    init_weights(model, seed)
    return model


def _fold(sd: Dict[str, torch.Tensor], conv: str, bn: str,
          out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm ``bn`` after convolution ``conv`` as one
    convolution: (weight x s, (bias - mean) s + beta), s = gamma /
    sqrt(var + eps) on the output channels (axis ``out_axis`` of the
    weight), computed in float64."""
    g, beta, mean, var = (sd[f"{bn}.{k}"].double() for k in _BN_KEYS)
    s = g / torch.sqrt(var + BN_EPS)
    w = sd[conv + ".weight"].double()
    shape = [1] * w.dim()
    shape[out_axis] = -1
    bias = sd.get(conv + ".bias")
    b = torch.zeros_like(mean) if bias is None else bias.double()
    return w * s.view(shape), (b - mean) * s + beta


def load_reference_state_dict(model: SapiensPose,
                              state_dict) -> SapiensPose:
    """Load Sapiens' weights ``{name: array}`` into ``model`` by name: the
    entries under ``backbone.`` and ``head.`` (the names in the module
    docstring; the BatchNorms' ``num_batches_tracked`` is not read), each
    BatchNorm of the head folded into the convolution before it.  Each
    tensor is copied into the model's own, on its device and in its dtype
    (a published ``qkv`` and ``proj`` padded as ``hmr2.Attention`` holds
    them)."""
    src = {k: (v.detach() if isinstance(v, torch.Tensor)
               else torch.as_tensor(v))
           for k, v in state_dict.items()
           if k.split(".")[0] in ("backbone", "head")
           and not k.endswith("num_batches_tracked")}
    want = published_names(model)
    missing = [k for k in want if k not in src]
    unexpected = [k for k in src if k not in want]
    if missing or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    sd = {}
    for k, v in src.items():
        if k.startswith("backbone."):
            for pattern, repl in _BACKBONE_NAMES:
                k = re.sub(pattern, repl, k)
            sd[k] = v
    for group, name, axis in (("deconv_layers", "deconv", 1),
                              ("conv_layers", "conv", 0)):
        for j in range(len(getattr(model.head, name))):
            sd[f"head.{name}.{j}.weight"], sd[f"head.{name}.{j}.bias"] = \
                _fold(src, f"head.{group}.{3 * j}",
                      f"head.{group}.{3 * j + 1}", axis)
    for k in ("weight", "bias"):
        sd["head.final_layer." + k] = src["head.final_layer." + k]
    model.load_state_dict(sd)
    return model
