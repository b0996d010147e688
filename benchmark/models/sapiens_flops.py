"""Operations of Sapiens pose (the ViT encoder and the deconvolution heatmap
head) on one frame, counted from the configuration's shapes, two a
multiply-add, whatever the program computes them with: attention at the
published head width (``head_dim``), whether or not the program pads its
heads.  Attention counts its two products (Q K^T and the weighted sum of V).
LayerNorm, BatchNorm, the softmax, GELU, ReLU, the adds and the decode are
not counted, as the convolutions' count leaves out BatchNorm elsewhere.
"""
from __future__ import annotations

from typing import Tuple


def grid(cfg: dict) -> Tuple[int, int]:
    """The patch convolution's output grid (rows, columns) over the
    ``image_size`` x ``crop_width`` crop."""
    def out(size: int) -> int:
        return ((size + 2 * cfg["patch_padding"] - cfg["patch_size"])
                // cfg["patch_size"] + 1)
    return out(cfg["image_size"]), out(cfg["crop_width"])


def tokens(cfg: dict) -> int:
    rows, cols = grid(cfg)
    return rows * cols


def patch_flops(cfg: dict) -> int:
    """The patch convolution."""
    p = cfg["patch_size"]
    return 2 * tokens(cfg) * 3 * p * p * cfg["embed_dim"]


def attention_flops(cfg: dict) -> int:
    """One block's attention half: qkv, Q K^T and A V over every head of
    ``head_dim``, proj."""
    n, d = tokens(cfg), cfg["embed_dim"]
    inner = cfg["num_heads"] * cfg["head_dim"]
    return 2 * (n * d * 3 * inner + 2 * n * n * inner + n * inner * d)


def mlp_flops(cfg: dict) -> int:
    """One block's MLP half: fc1 and fc2."""
    return 2 * 2 * tokens(cfg) * cfg["embed_dim"] * cfg["mlp_dim"]


def encoder_flops(cfg: dict) -> int:
    """The patch embedding and every block."""
    return patch_flops(cfg) + cfg["depth"] * (attention_flops(cfg)
                                              + mlp_flops(cfg))


def head_flops(cfg: dict) -> int:
    """The heatmap head: each deconvolution (every input pixel into
    ``kernel``^2 outputs), each 1 x 1 convolution and the final one."""
    rows, cols = grid(cfg)
    c_in, total = cfg["embed_dim"], 0
    k = cfg["deconv_kernel"]
    for c_out in cfg["deconv_channels"]:
        total += rows * cols * c_in * c_out * k * k
        rows, cols, c_in = 2 * rows, 2 * cols, c_out
    for c_out in [*cfg["conv_channels"], cfg["keypoints"]]:
        total += rows * cols * c_in * c_out
        c_in = c_out
    return 2 * total


def sapiens_pose_flops(cfg: dict) -> float:
    """Model operations of one frame through Sapiens pose."""
    return float(encoder_flops(cfg) + head_flops(cfg))
