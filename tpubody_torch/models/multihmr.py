"""Multi-HMR 896-L (Baradel et al., "Multi-HMR: Multi-Person Whole-Body
Human Mesh Recovery in a Single Shot", ECCV 2024, arXiv:2402.14654;
github.com/naver/multi-hmr): a DINOv2 ViT-L/14 encoder (Oquab et al.,
arXiv:2304.07193) over a whole 896^2 image, and a cross-attention Human
Prediction Head (HPH) that reads one SMPL-X body (Pavlakos et al., CVPR
2019) out of each person's centre patch.

Input (B, 896, 896, 3) NHWC normalised images and ``centres`` (B, P),
each person's patch index on the 64 x 64 grid (row-major; the configured
ones by default) -> ``hmr.HMROutput`` of the B * P bodies, image-major:
rotation matrices (B P, 55, 3, 3) (SMPL-X's order; the two eyes
identity), betas ⊕ expression (B P, 20), the placement (B P, 3) and the
6D pose (B P, 318).  The placement is the 3D point where the body's head
joint (SMPL-X joint 15, :data:`ANCHOR_JOINT`) goes: the serving step
turns it into the body's translation, which needs the body
(``HMRSMPLStep``, ``smpl.forward_batch_placed``).

The encoder: ``Conv2d(3, 1024, 14, stride 14)`` (no padding) gives a 64 x
64 grid; a cls token goes first (4,097 tokens); ``pos_embed`` (1 + 37^2
entries, learned at 518^2) is added, its grid part interpolated once at
load to 64 x 64 (bicubic, ``align_corners=False``, the cls entry kept);
24 pre-norm blocks ``x += ls1 * proj(attn(qkv(LN1(x))))``, ``x += ls2 *
fc2(GELU(fc1(LN2(x))))`` (LayerNorm eps 1e-6, 16 heads of 64, LayerScale
``ls1.gamma`` and ``ls2.gamma``), the final ``norm``; the 4,096 patch
tokens are kept.

The head: each patch token gets its camera ray's Fourier encoding
(:func:`ray_encoding`: ``d = K^-1 [u, v, 1]`` at the patch centre, ``K``
of a 60 degree field of view, 3 + 3 x 16 x 2 = 99 channels), so the
context is 1,123 wide, and learned row and column embeddings (64, 1123)
each.  A person's query is its centre context token ⊕ the mean pose (53
x 6D), betas (10) and camera (3), 1,454 wide, through 4D-Humans'
``TransformerDecoder`` (``hmr2.TransformerDecoder``: 2 layers of 1,024,
self-attention over the person's one token, cross-attention to its
image's 4,096 context tokens in 8 heads of 32, a feed-forward network of
1,024).  ``decpose``, ``decshape``, ``deccam`` and ``decexpression`` add
to the mean values (expression from zero); ``mlp_offset`` reads the
sub-patch offset off the centre's encoder token.  The nearness n is the
camera's first value: the head joint lies at depth ``z = exp(-n)`` on the
ray through the patch centre plus ``patch_size`` x the offset.

Persons are given, not detected: Multi-HMR's inference scores every patch
(``mlp_classif``) and keeps local maxima above a threshold; here the
caller names the centres, as Multi-HMR's training forward takes them from
the ground truth.

Precision, as HMR 2.0's (``models/hmr2.py``): the patch convolution and
every Linear of the encoder and the decoder take ``dtype`` operands and
accumulate in float32; the LayerNorms, the softmax, the residual streams
and LayerScale are float32; the context is cast to ``dtype`` once; the
offset head, the readouts and the pose state are float32.  The encoder
runs each LayerScaled residual add with the LayerNorm after it and its
cast in one :func:`hmr2.add_layernorm` (``csrc/add_layernorm.cu`` on the
card): 48 launches a forward, the last writing the float32 ``norm``.

State-dict names are DINOv2's and Multi-HMR's: ``backbone.encoder.
{patch_embed.proj, cls_token, pos_embed, norm}``, ``backbone.encoder.
blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1,
mlp.fc2, ls2.gamma}``, ``x_attention_head.{row_embed, col_embed,
mlp_offset.{0,2}, transformer.*, decpose, decshape, deccam,
decexpression, init_body_pose, init_betas, init_cam}``.  The head's names
below ``x_attention_head``, the ray encoding's layout, the embeddings'
form and the 53 rotations' order are this port's reading, unconfirmed
against a released checkpoint.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpubody_torch.core.rotations import rot6d_to_rotmat
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.models import hmr2
from tpubody_torch.models.hmr import HMROutput
from tpubody_torch.utils.profiling import span

N_JOINTS = 55                   # SMPL-X
# The 53 predicted rotations are SMPL-X's joints but the eyes: the root,
# 21 body joints, the jaw, then 15 joints of each hand.
PRED_JOINTS = tuple(range(23)) + tuple(range(25, 55))
EYES = (23, 24)
NPOSE = 6 * len(PRED_JOINTS)    # 318
N_BETAS = 10
N_EXPRESSION = 10
ANCHOR_JOINT = 15               # SMPL-X's head
ENCODER_EPS = hmr2.ENCODER_EPS
MEAN_DEPTH = 5.0                # metres, the default mean placement
MEAN_KEYS = ("init_body_pose", "init_betas", "init_cam")
# Eight persons on the 64 x 64 grid (row * 64 + column): two rows of four.
DEFAULT_CENTRES = (24 * 64 + 10, 24 * 64 + 22, 24 * 64 + 34, 24 * 64 + 46,
                   40 * 64 + 16, 40 * 64 + 28, 40 * 64 + 40, 40 * 64 + 52)


def default_mean_params(depth: float = MEAN_DEPTH) -> np.ndarray:
    """(318 + 10 + 3,) the head's start: each of the 53 rotations the
    identity's first two columns as ``rot6d_to_rotmat`` reads them, zero
    betas, camera (nearness ``-log(depth)``, 0, 0)."""
    pose = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32),
                   len(PRED_JOINTS))
    return np.concatenate([pose, np.zeros(N_BETAS, np.float32),
                           np.array([-math.log(depth), 0, 0], np.float32)])


def intrinsics(image_size: int, fov_deg: float) -> torch.Tensor:
    """(3, 3) ``K`` of a square image with the field of view ``fov_deg``:
    focal ``(image_size / 2) / tan(fov / 2)``, the principal point at the
    centre."""
    f = image_size / 2 / math.tan(math.radians(fov_deg) / 2)
    c = image_size / 2
    return torch.tensor([[f, 0, c], [0, f, c], [0, 0, 1]],
                        dtype=torch.float64)


def patch_rays(image_size: int, patch_size: int,
               fov_deg: float) -> torch.Tensor:
    """(grid^2, 3) float64 ``K^-1 [u, v, 1]`` at each patch centre,
    row-major: ``u = (column + 0.5) * patch_size``, ``v`` of the row."""
    grid = image_size // patch_size
    centre = (torch.arange(grid, dtype=torch.float64) + 0.5) * patch_size
    v, u = torch.meshgrid(centre, centre, indexing="ij")
    uv1 = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    return uv1 @ torch.linalg.inv(intrinsics(image_size, fov_deg)).T


def ray_encoding(d: torch.Tensor, bands: int = 16,
                 max_resolution: int = 64) -> torch.Tensor:
    """Perceiver's Fourier encoding of (..., 3) rays: ``[d, sin(pi f_k
    d_i), cos(pi f_k d_i)]`` with ``f = linspace(1, max_resolution / 2,
    bands)``, the sines and the cosines each ray-coordinate-major ->
    (..., 3 + 6 * bands)."""
    f = torch.linspace(1.0, max_resolution / 2, bands, dtype=d.dtype,
                       device=d.device)
    arg = (math.pi * d[..., :, None] * f).flatten(-2)
    return torch.cat([d, torch.sin(arg), torch.cos(arg)], dim=-1)


# -- the encoder: DINOv2 ViT-L/14 ------------------------------------------
class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class DinoBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.attn = hmr2.Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.mlp = hmr2.Mlp(dim, mlp_dim)
        self.ls2 = LayerScale(dim)


class DinoViT(nn.Module):
    """(B, image_size, image_size, 3) NHWC -> (B, grid^2, dim) float32
    patch tokens after ``norm``."""

    def __init__(self, image_size: int = 896, patch_size: int = 14,
                 dim: int = 1024, depth: int = 24, heads: int = 16,
                 mlp_dim: int = 4096, pos_grid: int = 37):
        super().__init__()
        self.image_size, self.pos_grid = image_size, pos_grid
        self.grid = image_size // patch_size
        self.patch_embed = hmr2.PatchEmbed(patch_size, dim, padding=0)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid ** 2, dim))
        self.register_buffer("pos_table",
                             torch.zeros(1, 1 + self.grid ** 2, dim),
                             persistent=False)
        self.blocks = nn.ModuleList(DinoBlock(dim, heads, mlp_dim)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=ENCODER_EPS)

    @torch.no_grad()
    def interpolate_pos_embed(self) -> None:
        """``pos_table``: ``pos_embed``'s grid part resized to the image's
        grid (bicubic, ``align_corners=False``) after its cls entry."""
        pos = self.pos_embed.float()
        g, D = self.pos_grid, pos.shape[-1]
        part = pos[:, 1:].reshape(1, g, g, D).permute(0, 3, 1, 2)
        part = F.interpolate(part, size=(self.grid, self.grid),
                             mode="bicubic", align_corners=False)
        self.pos_table.copy_(torch.cat(
            [pos[:, :1], part.flatten(2).transpose(1, 2)], dim=1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if tuple(images.shape[1:]) != (self.image_size, self.image_size, 3):
            raise ValueError(f"DinoViT takes (B, {self.image_size}, "
                             f"{self.image_size}, 3) images, got "
                             f"{tuple(images.shape)}")
        with span("multihmr.backbone"):
            x = self.patch_embed(images).float()
            cls = self.cls_token.float().expand(len(x), -1, -1)
            x = torch.cat([cls, x], dim=1) + self.pos_table
            # Each half ends with its LayerScaled residual add and the
            # LayerNorm after it (norm2, the next block's norm1, or norm in
            # float32) in one add_layernorm; the last drops the stream.
            first = self.blocks[0]
            h = first.norm1(x).to(first.attn.qkv.weight.dtype)
            for block, nxt in zip(self.blocks, [*self.blocks[1:], None]):
                with span("multihmr.attention"):
                    x, h = hmr2.add_layernorm(
                        x, block.attn(h), block.norm2,
                        block.mlp.fc1.weight.dtype, scale=block.ls1.gamma)
                with span("multihmr.mlp"):
                    if nxt is None:
                        return hmr2.add_layernorm(
                            x, block.mlp(h), self.norm, torch.float32,
                            keep_x=False, scale=block.ls2.gamma)[1][:, 1:]
                    x, h = hmr2.add_layernorm(
                        x, block.mlp(h), nxt.norm1,
                        nxt.attn.qkv.weight.dtype, scale=block.ls2.gamma)


class Backbone(nn.Module):
    """Multi-HMR's ``backbone``: the DINOv2 ``encoder``."""

    def __init__(self, **widths):
        super().__init__()
        self.encoder = DinoViT(**widths)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)


# -- the Human Prediction Head -----------------------------------------------
class HPH(nn.Module):
    """(B, grid^2, dim) encoder tokens and (B, P) centres -> the bodies'
    ``HMROutput`` (see the module docstring)."""

    def __init__(self, mean: np.ndarray, image_size: int = 896,
                 patch_size: int = 14, encoder_dim: int = 1024,
                 fov_deg: float = 60.0, ray_bands: int = 16,
                 ray_max_resolution: int = 64, dim: int = 1024,
                 depth: int = 2, heads: int = 8, dim_head: int = 32,
                 mlp_dim: int = 1024):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.grid = image_size // patch_size
        self.focal = float(intrinsics(image_size, fov_deg)[0, 0])
        rays = ray_encoding(patch_rays(image_size, patch_size, fov_deg),
                            ray_bands, ray_max_resolution)
        self.register_buffer("rays", rays.float(), persistent=False)
        context = encoder_dim + rays.shape[-1]
        self.row_embed = nn.Parameter(torch.zeros(self.grid, context))
        self.col_embed = nn.Parameter(torch.zeros(self.grid, context))
        self.mlp_offset = nn.Sequential(nn.Linear(encoder_dim, encoder_dim),
                                        nn.ReLU(), nn.Linear(encoder_dim, 2))
        self.transformer = hmr2.TransformerDecoder(
            dim, depth, heads, dim_head, mlp_dim, context,
            token_dim=context + NPOSE + N_BETAS + 3)
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, N_BETAS)
        self.deccam = nn.Linear(dim, 3)
        self.decexpression = nn.Linear(dim, N_EXPRESSION)
        mean = torch.as_tensor(np.asarray(mean, np.float32))
        for name, value in zip(MEAN_KEYS, mean.split([NPOSE, N_BETAS, 3])):
            self.register_buffer(name, value.reshape(1, -1).clone())

    def forward(self, tokens: torch.Tensor,
                centres: torch.Tensor) -> HMROutput:
        with span("multihmr.head"):
            B, P = centres.shape
            image = torch.arange(B, device=tokens.device).repeat_interleave(P)
            at = centres.reshape(-1)
            pos = (self.row_embed[:, None] + self.col_embed[None]).flatten(0, 1)
            context = torch.cat(
                [tokens, self.rays.expand(B, -1, -1)], dim=-1) + pos
            query = torch.cat([context[image, at],
                               self.init_body_pose.expand(B * P, -1),
                               self.init_betas.expand(B * P, -1),
                               self.init_cam.expand(B * P, -1)], dim=-1)
            dtype = self.transformer.to_token_embedding.weight.dtype
            h = self.transformer(query[:, None],
                                 context.to(dtype)[image])[:, 0]
            offset = self.mlp_offset(tokens[image, at])
            pose = self.decpose(h) + self.init_body_pose
            betas = self.decshape(h) + self.init_betas
            cam = self.deccam(h) + self.init_cam
            expression = self.decexpression(h)
            rot = rot6d_to_rotmat(pose.view(B * P, -1, 6))
            eyes = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(
                B * P, len(EYES), 3, 3)
            rotmats = torch.cat([rot[:, :EYES[0]], eyes, rot[:, EYES[0]:]],
                                dim=1)
            return HMROutput(rotmats=rotmats,
                             shape=torch.cat([betas, expression], dim=-1),
                             cam=self.placement(at, offset, cam[:, 0]),
                             pose6d=pose)

    def placement(self, at: torch.Tensor, offset: torch.Tensor,
                  nearness: torch.Tensor) -> torch.Tensor:
        """(N,) patch indices, (N, 2) sub-patch offsets in patches and (N,)
        nearness -> (N, 3): ``exp(-nearness) K^-1 [u, v, 1]`` at the patch
        centre plus ``patch_size`` x the offset."""
        c = self.image_size / 2
        row = torch.div(at, self.grid, rounding_mode="floor")
        u = ((at - row * self.grid) + 0.5 + offset[:, 0]) * self.patch_size
        v = (row + 0.5 + offset[:, 1]) * self.patch_size
        ray = torch.stack([(u - c) / self.focal, (v - c) / self.focal,
                           torch.ones_like(u)], dim=-1)
        return torch.exp(-nearness)[:, None] * ray


class MultiHMR(nn.Module):
    """Multi-HMR.  ``mean_params``: (318 + 10 + 3,) the head's start, the
    6D pose in the port's layout (:func:`default_mean_params`);
    ``centres``: the P persons' default patch indices on the grid.

    Inference only on CUDA: the encoder's :func:`hmr2.add_layernorm` has
    no backward there."""

    anchor_joint = ANCHOR_JOINT

    def __init__(self, mean_params: np.ndarray, image_size: int = 896,
                 patch_size: int = 14, dim: int = 1024, depth: int = 24,
                 heads: int = 16, mlp_dim: int = 4096, pos_grid: int = 37,
                 fov_deg: float = 60.0, ray_bands: int = 16,
                 ray_max_resolution: int = 64, head_dim: int = 1024,
                 head_depth: int = 2, head_heads: int = 8,
                 head_dim_head: int = 32, head_mlp_dim: int = 1024,
                 centres: Sequence[int] = DEFAULT_CENTRES):
        super().__init__()
        self.image_size = image_size
        self.backbone = Backbone(image_size=image_size,
                                 patch_size=patch_size, dim=dim, depth=depth,
                                 heads=heads, mlp_dim=mlp_dim,
                                 pos_grid=pos_grid)
        self.x_attention_head = HPH(
            mean_params, image_size, patch_size, dim, fov_deg, ray_bands,
            ray_max_resolution, head_dim, head_depth, head_heads,
            head_dim_head, head_mlp_dim)
        grid = self.x_attention_head.grid
        centres = torch.as_tensor(list(centres), dtype=torch.long)
        if centres.dim() != 1 or not len(centres) or \
                not bool(((centres >= 0) & (centres < grid ** 2)).all()):
            raise ValueError(f"centres: patch indices on the {grid} x {grid} "
                             f"grid, got {centres.tolist()}")
        self.register_buffer("centres", centres, persistent=False)

    @property
    def persons(self) -> int:
        """P, the persons of a frame at the default centres."""
        return len(self.centres)

    def forward(self, images: torch.Tensor,
                centres: Optional[torch.Tensor] = None) -> HMROutput:
        """images: (B, image_size, image_size, 3) NHWC, normalised;
        ``centres`` (B, P) patch indices, by default the model's."""
        return self.head(self.backbone(images), centres)

    def head(self, tokens: torch.Tensor,
             centres: Optional[torch.Tensor] = None) -> HMROutput:
        """The HPH on the encoder's tokens (what follows the backbone, by
        the name the serving step calls)."""
        if centres is None:
            centres = self.centres.expand(len(tokens), -1)
        return self.x_attention_head(tokens, torch.as_tensor(
            centres, dtype=torch.long, device=tokens.device))


# -- weights ----------------------------------------------------------------
@torch.no_grad()
def init_weights(model: MultiHMR, seed: int = 0) -> None:
    """Seeded initialisation on the CPU generator: DINOv2's for the
    encoder (Linears truncated normal std 0.02 with zero bias, ``cls_token``
    normal std 1e-6, ``pos_embed`` truncated normal std 0.02, LayerScale
    1e-5, LayerNorm (1, 0), the patch convolution PyTorch's default), then
    the position table; PyTorch's defaults for the head's Linears, the
    embeddings normal std 0.02, and the readouts xavier-uniform with gain
    0.01 and zero bias, as ``hmr2.init_weights`` gives them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def fill(t, draw):
        t.copy_(draw(torch.empty(t.shape, dtype=torch.float32)))

    def default(m):
        bound = m.weight[0].numel() ** -0.5
        fill(m.weight, lambda t: nn.init.kaiming_uniform_(
            t, a=5 ** 0.5, generator=gen))
        if m.bias is not None:
            fill(m.bias, lambda t: nn.init.uniform_(t, -bound, bound,
                                                    generator=gen))

    vit = model.backbone.encoder
    default(vit.patch_embed.proj)
    fill(vit.cls_token, lambda t: nn.init.normal_(t, std=1e-6,
                                                  generator=gen))
    fill(vit.pos_embed, lambda t: nn.init.trunc_normal_(
        t, std=hmr2.INIT_STD, generator=gen))
    for m in vit.modules():
        if isinstance(m, nn.Linear):
            fill(m.weight, lambda t: nn.init.trunc_normal_(
                t, std=hmr2.INIT_STD, generator=gen))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(1e-5)
    vit.interpolate_pos_embed()
    head = model.x_attention_head
    for m in [*head.transformer.modules(), *head.mlp_offset]:
        if isinstance(m, nn.Linear):
            default(m)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    for t in (head.transformer.pos_embedding, head.row_embed,
              head.col_embed):
        fill(t, lambda t: nn.init.normal_(t, std=hmr2.INIT_STD,
                                          generator=gen))
    for m in (head.decpose, head.decshape, head.deccam, head.decexpression):
        fill(m.weight, lambda t: nn.init.xavier_uniform_(
            t, gain=hmr2.HEAD_GAIN, generator=gen))
        m.bias.zero_()


def to_compute(model: MultiHMR, dtype: torch.dtype,
               device: torch.device) -> MultiHMR:
    """Move ``model`` to ``device`` with the patch convolution and every
    Linear of the encoder and the decoder in the compute ``dtype``; the
    LayerNorms, LayerScale, embeddings, offset head, readouts and mean
    parameters stay float32.  Eval mode."""
    model.to(device)
    for part in (model.backbone, model.x_attention_head.transformer):
        for m in part.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(dtype)
    return model.eval()


def create_multihmr(mean_params: Optional[np.ndarray] = None,
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                    device: DeviceLike = "cuda", **widths) -> MultiHMR:
    """Multi-HMR with seeded random weights (:func:`init_weights`), on
    ``device``, in eval mode.  ``mean_params`` defaults to
    :func:`default_mean_params`; ``widths`` are :class:`MultiHMR`'s size
    arguments (tests build tiny instances).  On CUDA the model takes no
    autograd: run it under ``torch.no_grad()`` or inference mode."""
    if mean_params is None:
        mean_params = default_mean_params()
    model = MultiHMR(mean_params, **widths)
    init_weights(model, seed)
    return to_compute(model, dtype, resolve(device))


def load_reference_state_dict(model: MultiHMR, state_dict) -> MultiHMR:
    """Load Multi-HMR's weights ``{name: array}`` into ``model`` by name:
    the entries under ``backbone.`` and ``x_attention_head.`` (a
    checkpoint's other modules, such as ``mlp_classif``, are not read),
    then the position table from the loaded ``pos_embed``.  The mean
    parameters ``x_attention_head.init_*`` may be absent; the model then
    keeps those it was built with.  Each tensor is copied into the
    model's own, on its device and in its dtype."""
    sd = {k: (v.detach() if isinstance(v, torch.Tensor)
              else torch.as_tensor(np.asarray(v)))
          for k, v in state_dict.items()
          if k.split(".")[0] in ("backbone", "x_attention_head")}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing
               if k not in {"x_attention_head." + n for n in MEAN_KEYS}]
    if missing or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    model.backbone.encoder.interpolate_pos_embed()
    return model
