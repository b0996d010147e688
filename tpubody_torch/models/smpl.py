"""SMPL-family body models on tensors (port of ``tpubody.models.smpl``).

``forward`` / ``forward_batch`` run the torch-op LBS of
:mod:`tpubody_torch.core.lbs` and return the whole posed state;
``forward_batch_verts`` is the throughput path, which on CUDA goes through
the fused LBS kernel (:mod:`tpubody_torch.core.fused_lbs`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpubody_torch.core import fused_lbs
from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.models.params import BodyModelParams


class BodyState(NamedTuple):
    """Posed body: everything downstream stages need from one forward pass."""

    verts: torch.Tensor           # (..., V, 3)
    joints_rest: torch.Tensor     # (..., J, 3)
    joints_posed: torch.Tensor    # (..., J, 3)
    rel_transforms: torch.Tensor  # (..., J, 4, 4)
    v_posed: torch.Tensor         # (..., V, 3)


def forward(
    model: BodyModelParams,
    pose: torch.Tensor,
    beta: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
    pose_is_rotmat: bool = False,
) -> BodyState:
    """One LBS forward pass: pose (..., J, 3) axis-angle (or (..., J, 3, 3)
    rotation matrices), beta (..., S), trans (..., 3)."""
    out = lbs_lib.lbs(
        model.v_template,
        model.shapedirs,
        model.posedirs,
        model.j_regressor,
        model.weights,
        model.parents,
        pose,
        beta,
        trans,
        pose_is_rotmat=pose_is_rotmat,
    )
    return BodyState(
        verts=out.verts,
        joints_rest=out.joints,
        joints_posed=out.joints_posed,
        rel_transforms=out.rel_transforms,
        v_posed=out.v_posed,
    )


def forward_batch(
    model: BodyModelParams,
    pose: torch.Tensor,   # (F, J, 3) or (F, J, 3, 3)
    beta: torch.Tensor,   # (S,) shared or (F, S) per-frame
    trans: Optional[torch.Tensor] = None,  # (F, 3) or None
    pose_is_rotmat: bool = False,
) -> BodyState:
    """Batched LBS over frames."""
    return forward(model, pose, beta, trans, pose_is_rotmat)


def forward_batch_verts(
    model: BodyModelParams,
    poses: torch.Tensor,   # (F, J, 3) axis-angle or (F, J, 3, 3) rotmats
    beta: torch.Tensor,    # (S,) shared or (F, S) per-frame shape
    trans: Optional[torch.Tensor] = None,
    use_kernel: Optional[bool] = None,
    pose_is_rotmat: bool = False,
    kernel_precision: str = "bf16x3",
) -> torch.Tensor:
    """Vertices-only batched forward, the throughput path -> (F, V, 3).

    ``use_kernel=None`` launches the fused CUDA kernel when the model's
    tensors are on CUDA and runs :func:`forward_batch` when they are on the
    CPU.  ``use_kernel=True`` on CPU tensors raises: the kernel exists
    only on the card.  ``use_kernel=False`` asks for :func:`forward_batch`.
    ``kernel_precision``: "bf16x3" (the default, as in ``tpubody``) or
    "highest" (full fp32)."""
    on_cuda = model.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("use_kernel=True needs the body model on a CUDA "
                         f"device; it is on {model.device}")
    if use_kernel:
        return fused_lbs.lbs_forward_batch_fused(
            model.v_template, model.shapedirs, model.posedirs,
            model.j_regressor, model.weights, model.parents,
            poses, beta, trans, pose_is_rotmat=pose_is_rotmat,
            kernel_precision=kernel_precision,
            layouts=fused_lbs.model_layouts(model))
    return forward_batch(model, poses, beta, trans,
                         pose_is_rotmat=pose_is_rotmat).verts


def regress_joints(model: BodyModelParams, verts: torch.Tensor) -> torch.Tensor:
    """3D joints from posed vertices: j_regressor (J, V) x verts (..., V, 3)."""
    return torch.matmul(model.j_regressor, verts)
