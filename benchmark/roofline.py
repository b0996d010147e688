"""Operations and bytes of the work, counted from its shapes, and the
published peaks of the card.

The counts do not depend on how the program computes the work: a kernel's
operations are those its function needs (two a multiply-add), and its
bytes are each input read once and each output written once, in the type
the configuration holds it in.

Peaks: NVIDIA's H100 SXM5 data sheet, dense rates without sparsity, at the
full 700 W; a card set to a lower power limit reaches less.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

STAGE_FEATURES = (64, 128, 256, 512)

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
        "tf32": 495e12, "fp32": 67e12, "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, what: str) -> Optional[float]:
    """The card's published peak for ``what`` (a precision, or
    ``hbm_bytes_per_s``), or None for a card this table does not hold."""
    return PEAKS.get(kind, {}).get(what)


def resnet50_macs(image_size: int = 224,
                  stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> int:
    """Multiply-adds of ResNet-50's convolutions on one square image (the
    v1.5 bottleneck: the stride on its 3x3 convolution and on the
    projection)."""
    def out(size: int, stride: int) -> int:
        return (size - 1) // stride + 1

    size = out(image_size, 2)                      # conv1, 7x7 stride 2
    macs = size * size * 3 * 64 * 49
    size = out(size, 2)                            # max-pool, stride 2
    c_in = 64
    for i, (n_blocks, f) in enumerate(zip(stage_sizes, STAGE_FEATURES)):
        for j in range(n_blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            o = out(size, stride)
            macs += size * size * c_in * f             # conv1, 1x1
            macs += o * o * f * f * 9                  # conv2, 3x3
            macs += o * o * f * 4 * f                  # conv3, 1x1
            if j == 0:
                macs += o * o * c_in * 4 * f           # projection, 1x1
            size, c_in = o, 4 * f
    return macs


def ief_flops(features: int = 2048, hidden: int = 1024, npose: int = 144,
              nshape: int = 10, ncam: int = 3, n_iter: int = 3) -> int:
    """The IEF regressor on one frame: fc1, fc2 and the three decoders, each
    iteration."""
    d_in = features + npose + nshape + ncam
    return n_iter * 2 * (d_in * hidden + hidden * hidden
                         + hidden * (npose + nshape + ncam))


def lbs_flops(frames: int, verts: int, joints: int, k: int) -> int:
    """Linear blend skinning: the blend shapes (each coordinate a K-term
    sum, K = pose blend + betas + template), the blended transforms (12
    entries, J terms each) and their application (3 rows of 4)."""
    return 2 * frames * verts * (3 * k + 12 * joints + 12)


def lbs_bytes(frames: int, verts: int, joints: int, n_betas: int,
              n_pose: int) -> int:
    """float32 bytes: the template, shape and pose bases, the skinning
    weights, each frame's features (pose feature, betas, 1) and 3x4
    transforms, read once; the vertices written once."""
    k = n_pose + n_betas + 1
    model = verts * 3 * k + verts * joints
    per_frame = k + joints * 12 + verts * 3
    return 4 * (model + frames * per_frame)


def lbs_shape(cfg: dict) -> dict:
    """The skinning's sizes of an HMR + SMPL configuration."""
    return {"verts": cfg["smpl_vertices"], "joints": cfg["smpl_joints"],
            "n_betas": cfg["n_betas"], "n_pose": cfg["smpl_pose_blend"]}


def lbs_seconds(cfg: dict, frames: int, kind: str) -> Optional[float]:
    """The least time the card could take for the skinning of ``frames``:
    the larger of its operations at the bf16 peak (the highest any
    implementation could use) and its bytes at the memory bandwidth."""
    s = lbs_shape(cfg)
    flop_peak, bw = peak(kind, "bf16"), peak(kind, "hbm_bytes_per_s")
    if flop_peak is None or bw is None:
        return None
    k = s["n_pose"] + s["n_betas"] + 1
    return max(lbs_flops(frames, s["verts"], s["joints"], k) / flop_peak,
               lbs_bytes(frames, s["verts"], s["joints"], s["n_betas"],
                         s["n_pose"]) / bw)


def hmr_smpl_flops(cfg: dict) -> float:
    """Model operations of one frame through HMR + SMPL."""
    s = lbs_shape(cfg)
    k = s["n_pose"] + s["n_betas"] + 1
    npose = cfg["pose_joints"] * cfg["pose_rep_dim"]
    return float(2 * resnet50_macs(cfg["image_size"], cfg["stage_sizes"])
                 + ief_flops(cfg["backbone_features"], cfg["ief_hidden"],
                             npose, cfg["n_betas"], cfg["n_cam"],
                             cfg["ief_iterations"])
                 + lbs_flops(1, s["verts"], s["joints"], k))
