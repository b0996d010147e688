"""Standard 3D pose / mesh evaluation metrics: MPJPE, PA-MPJPE, PVE
(port of ``tpubody.utils.pose_eval``).

Conventions match the common SPIN/HMR evaluation code: errors are mean
per-joint Euclidean distances after root-centering (MPJPE) or after a full
similarity Procrustes alignment (PA-MPJPE, a.k.a. reconstruction error).
Units follow the inputs (meters for SMPL-scale bodies).  Batched tensor
ops, so validation runs on the device beside training
(``models/hmr_train.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor,
                     eps: float = 1e-12) -> torch.Tensor:
    """Similarity-transform (scale, rotation, translation) alignment of
    ``pred`` onto ``gt``; both (..., J, 3).  Returns the aligned prediction.

    Closed-form orthogonal Procrustes via SVD of the cross-covariance, with
    the reflection guard (det correction) so the rotation is proper.
    """
    mu_p = pred.mean(dim=-2, keepdim=True)
    mu_g = gt.mean(dim=-2, keepdim=True)
    xp = pred - mu_p
    xg = gt - mu_g

    var_p = (xp * xp).sum(dim=(-2, -1))                          # (...,)
    K = torch.einsum("...ji,...jk->...ik", xg, xp)               # (..., 3, 3)
    U, s, Vt = torch.linalg.svd(K)
    # Proper rotation: flip the smallest singular direction if det < 0.
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    trace = (s * D).sum(dim=-1)
    scale = trace / torch.clamp(var_p, min=eps)

    aligned = scale[..., None, None] * torch.einsum("...jk,...ik->...ij",
                                                    R, xp)
    return aligned + mu_g


def mpjpe(pred: torch.Tensor, gt: torch.Tensor,
          root: Optional[int] = 0) -> torch.Tensor:
    """Mean per-joint position error after root-centering (root=None skips
    centering).  pred/gt: (..., J, 3) -> (...) per-example means."""
    if root is not None:
        pred = pred - pred[..., root:root + 1, :]
        gt = gt - gt[..., root:root + 1, :]
    return torch.linalg.norm(pred - gt, dim=-1).mean(dim=-1)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE (reconstruction error)."""
    return torch.linalg.norm(procrustes_align(pred, gt) - gt,
                             dim=-1).mean(dim=-1)


def pve(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """Per-vertex error: mean vertex distance, no alignment (both meshes
    assumed in the same frame, e.g. root-centered SMPL outputs)."""
    return torch.linalg.norm(pred_verts - gt_verts, dim=-1).mean(dim=-1)


def evaluate_batch(pred_joints: torch.Tensor,
                   gt_joints: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, J, 3) x2 -> {"mpjpe": (B,), "pa_mpjpe": (B,)}."""
    return {"mpjpe": mpjpe(pred_joints, gt_joints),
            "pa_mpjpe": pa_mpjpe(pred_joints, gt_joints)}
