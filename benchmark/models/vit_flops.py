"""Operations of HMR 2.0 (the ViT-H/16 encoder and the transformer decoder)
on one frame, counted from the configuration's shapes, two a multiply-add,
whatever the program computes them with.  Attention counts its two products
(Q K^T and the weighted sum of V); LayerNorm, the softmax, GELU and the
adds are not counted, as the convolutions' count leaves out BatchNorm.
"""
from __future__ import annotations

from benchmark import roofline


def grid(cfg: dict) -> int:
    """Tokens of the patch embedding: the convolution's output grid over
    the ``image_size`` x ``crop_width`` crop."""
    def out(size: int) -> int:
        return ((size + 2 * cfg["patch_padding"] - cfg["patch_size"])
                // cfg["patch_size"] + 1)
    return out(cfg["image_size"]) * out(cfg["crop_width"])


def block_flops(cfg: dict) -> int:
    """One encoder block: qkv, Q K^T and A V over every head, proj, fc1,
    fc2."""
    n, d, m = grid(cfg), cfg["embed_dim"], cfg["mlp_dim"]
    return 2 * (n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * m)


def encoder_flops(cfg: dict) -> int:
    """The patch embedding and every block."""
    p = cfg["patch_size"]
    patch = 2 * grid(cfg) * 3 * p * p * cfg["embed_dim"]
    return patch + cfg["depth"] * block_flops(cfg)


def decoder_flops(cfg: dict) -> int:
    """The token embedding, each layer (self-attention over the one token,
    cross-attention to the encoder's tokens, the feed-forward network) and
    the readout."""
    dim, n = cfg["decoder_dim"], grid(cfg)
    inner = cfg["decoder_heads"] * cfg["decoder_dim_head"]
    self_attn = dim * 3 * inner + 2 * inner + inner * dim
    cross_attn = (dim * inner + n * cfg["context_dim"] * 2 * inner
                  + 2 * n * inner + inner * dim)
    feed_forward = 2 * dim * cfg["decoder_mlp_dim"]
    readout = dim * (cfg["pose_joints"] * cfg["pose_rep_dim"]
                     + cfg["n_betas"] + cfg["n_cam"])
    return 2 * (cfg["token_dim"] * dim + readout + cfg["decoder_depth"]
                * (self_attn + cross_attn + feed_forward))


def hmr2_smpl_flops(cfg: dict) -> float:
    """Model operations of one frame through HMR 2.0 and SMPL."""
    s = roofline.lbs_shape(cfg)
    k = s["n_pose"] + s["n_betas"] + 1
    return float(encoder_flops(cfg) + decoder_flops(cfg)
                 + roofline.lbs_flops(1, s["verts"], s["joints"], k))
