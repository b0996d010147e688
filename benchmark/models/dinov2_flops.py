"""Operations of Multi-HMR (the DINOv2 ViT-L/14 encoder, the Human Prediction
Head) and SMPL-X on one frame, counted from the configuration's shapes, two a
multiply-add, whatever the program computes them with.  Attention counts its
two products (Q K^T and the weighted sum of V).  The head's context K/V
projection is counted once an image, for all its persons.  LayerNorm, the
softmax, GELU, LayerScale, the ray encoding and the adds are not counted, as
the convolutions' count leaves out BatchNorm.
"""
from __future__ import annotations

from benchmark import roofline


def patches(cfg: dict) -> int:
    """Patch tokens of the encoder: the patch convolution's grid."""
    return (cfg["image_size"] // cfg["patch_size"]) ** 2


def attention_flops(cfg: dict) -> int:
    """One block's attention half over the patches and the cls token:
    qkv, Q K^T and A V over every head, proj."""
    n, d = patches(cfg) + 1, cfg["embed_dim"]
    return 2 * (n * d * 3 * d + 2 * n * n * d + n * d * d)


def mlp_flops(cfg: dict) -> int:
    """One block's MLP half: fc1 and fc2."""
    n, d = patches(cfg) + 1, cfg["embed_dim"]
    return 2 * 2 * n * d * cfg["mlp_dim"]


def encoder_flops(cfg: dict) -> int:
    """The patch embedding and every block."""
    p = cfg["patch_size"]
    patch = 2 * patches(cfg) * 3 * p * p * cfg["embed_dim"]
    return patch + cfg["depth"] * (attention_flops(cfg) + mlp_flops(cfg))


def head_flops(cfg: dict) -> int:
    """The HPH on one frame of ``persons`` persons: the context's K/V
    projection once; for each person the offset head, the token embedding,
    each layer's self-attention over the one token, query projection,
    attention to the context and output, the feed-forward network, and the
    readouts."""
    n, c = patches(cfg), cfg["context_dim"]
    dim, d_enc = cfg["hph_dim"], cfg["embed_dim"]
    inner = cfg["hph_heads"] * cfg["hph_dim_head"]
    kv = cfg["hph_depth"] * n * c * 2 * inner
    self_attn = dim * 3 * inner + 2 * inner + inner * dim
    cross_attn = dim * inner + 2 * n * inner + inner * dim
    feed_forward = 2 * dim * cfg["hph_mlp_dim"]
    readout = dim * (cfg["pose_joints"] * cfg["pose_rep_dim"]
                     + cfg["n_betas"] + cfg["n_cam"] + cfg["n_expression"])
    offset = d_enc * d_enc + d_enc * 2
    person = (offset + cfg["token_dim"] * dim + readout + cfg["hph_depth"]
              * (self_attn + cross_attn + feed_forward))
    return 2 * (kv + cfg["persons"] * person)


def lbs_k(cfg: dict) -> int:
    """The skinning's blend-shape terms: pose blend shapes, betas,
    expression and the template."""
    return (cfg["smpl_pose_blend"] + cfg["n_betas"] + cfg["n_expression"]
            + 1)


def multihmr_smplx_flops(cfg: dict) -> float:
    """Model operations of one frame through Multi-HMR and SMPL-X for its
    ``persons`` bodies."""
    return float(encoder_flops(cfg) + head_flops(cfg)
                 + roofline.lbs_flops(cfg["persons"], cfg["smpl_vertices"],
                                      cfg["smpl_joints"], lbs_k(cfg)))
