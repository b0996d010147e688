"""Fused batched LBS: the CUDA kernel ``csrc/fused_lbs.cu`` and its plain
PyTorch version.

Port of ``tpubody.core.pallas_lbs`` (the Pallas kernel ``_fused_kernel``).
The batched SMPL forward splits into

  (a) small per-frame work, kept as torch ops (:func:`lbs_prologue`):
      joints per frame, Rodrigues (or given rotation matrices), the pose
      feature, forward kinematics -> the 3x4 top of each rest-relative
      joint transform, and the feature row [pose_feat | betas | 1];
  (b) heavy per-(frame, vertex) work, fused into one kernel
      (:func:`fused_lbs`): blendshaped vertices from the concatenated basis
      [posedirs | shapedirs | v_template], blended transforms from the
      skinning weights, and their application, written as (F, V, 3).

The per-model layouts (basis (3, K, V), weights (J, V), joint bases) are
computed once per body model and cached on it (:func:`model_layouts`).

``fused_lbs`` launches the kernel for CUDA tensors and raises if it
cannot; it uses :func:`fused_lbs_reference`, the same arithmetic in plain
torch ops, only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from tpubody_torch import native
from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.core.rotations import rodrigues

PRECISIONS = ("highest", "bf16x3")


class LBSLayouts(NamedTuple):
    """Per-model constants in the layouts the kernel reads."""

    basis: torch.Tensor        # (3, K, V): [posedirs | shapedirs | v_template]
    wT: torch.Tensor           # (J, V) skinning weights, transposed
    base_joints: torch.Tensor  # (J, 3)  j_regressor @ v_template
    j_shape: torch.Tensor      # (J, 3, S) j_regressor @ shapedirs


def model_layouts(model) -> LBSLayouts:
    """The kernel layouts of ``model`` (a ``BodyModelParams``), computed on
    first use and cached on the model."""
    cached = model.cache.get("fused_lbs")
    if cached is None:
        cached = make_layouts(model.v_template, model.shapedirs,
                              model.posedirs, model.j_regressor,
                              model.weights)
        model.cache["fused_lbs"] = cached
    return cached


def make_layouts(v_template, shapedirs, posedirs, j_regressor,
                 weights) -> LBSLayouts:
    """Kernel layouts from the raw model tensors (V, 3), (V, 3, S),
    (V, 3, P), (J, V), (V, J)."""
    basis = torch.cat([posedirs, shapedirs, v_template[:, :, None]], dim=2)
    return LBSLayouts(
        basis=basis.permute(1, 2, 0).contiguous(),
        wT=weights.t().contiguous(),
        base_joints=torch.matmul(j_regressor, v_template),
        j_shape=torch.einsum("jv,vcs->jcs", j_regressor, shapedirs),
    )


def lbs_prologue(layouts: LBSLayouts, parents: Sequence[int],
                 poses: torch.Tensor, beta: torch.Tensor,
                 pose_is_rotmat: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame inputs of the kernel -> (feat (F, K), g (F, J, 12)).

    poses: (F, J, 3) axis-angle or (F, J, 3, 3) rotation matrices;
    beta: (S,) shared or (F, S) per-frame shape."""
    F, J = poses.shape[0], poses.shape[1]
    S = layouts.j_shape.shape[-1]
    betas_f = beta.expand(F, S) if beta.dim() == 1 else beta
    joints_f = layouts.base_joints + torch.einsum(
        "jcs,fs->fjc", layouts.j_shape, betas_f)
    R = poses if pose_is_rotmat else rodrigues(poses)     # (F, J, 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    pose_feat = (R[:, 1:] - eye).reshape(F, 9 * (J - 1))
    G = lbs_lib.forward_kinematics(R, joints_f, parents)
    G_rel = lbs_lib.remove_rest_pose(G, joints_f)         # (F, J, 4, 4)
    g = G_rel[:, :, :3, :].reshape(F, J, 12).contiguous()
    ones = torch.ones((F, 1), dtype=pose_feat.dtype, device=pose_feat.device)
    feat = torch.cat([pose_feat, betas_f.to(pose_feat.dtype), ones], dim=1)
    return feat, g


def _split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16x3 product: both fp32 operands split into hi + lo bf16 parts,
    hi*hi + hi*lo + lo*hi summed in fp32 (lo*lo is below fp32 rounding)."""
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return (torch.matmul(ah, bh) + torch.matmul(ah, bl)
            + torch.matmul(al, bh))


def fused_lbs_reference(basis: torch.Tensor, wT: torch.Tensor,
                        feat: torch.Tensor, g: torch.Tensor,
                        trans: Optional[torch.Tensor] = None,
                        precision: str = "bf16x3") -> torch.Tensor:
    """Plain torch version of the kernel: the same function and the same
    precision modes, (F, V, 3)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    dot = _dot3 if precision == "bf16x3" else torch.matmul
    F, J = g.shape[0], g.shape[1]
    vp = dot(feat, basis)                                  # (3, F, V)
    T = dot(g.permute(0, 2, 1).reshape(F * 12, J), wT)     # (F*12, V)
    T = T.reshape(F, 3, 4, -1)
    out = (T[:, :, 0] * vp[0][:, None] + T[:, :, 1] * vp[1][:, None]
           + T[:, :, 2] * vp[2][:, None] + T[:, :, 3])     # (F, 3, V)
    out = out.permute(0, 2, 1)
    if trans is not None:
        out = out + trans[:, None, :]
    return out.contiguous()


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_lbs(basis: torch.Tensor, wT: torch.Tensor, feat: torch.Tensor,
              g: torch.Tensor, trans: Optional[torch.Tensor] = None,
              precision: str = "bf16x3") -> torch.Tensor:
    """Fused LBS -> verts (F, V, 3).

    basis (3, K, V), wT (J, V), feat (F, K), g (F, J, 12), trans (F, 3) or
    None, all float32 and contiguous.  CUDA tensors go through the kernel
    (or this raises); CPU tensors through :func:`fused_lbs_reference`."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    device = basis.device
    if device.type == "cpu":
        return fused_lbs_reference(basis, wT, feat, g, trans, precision)
    if device.type != "cuda":
        raise ValueError(f"fused_lbs runs on CUDA or CPU tensors, got {device}")
    K, V = basis.shape[1], basis.shape[2]
    J, F = wT.shape[0], feat.shape[0]
    _check("basis", basis, (3, K, V), device)
    _check("wT", wT, (J, V), device)
    _check("feat", feat, (F, K), device)
    _check("g", g, (F, J, 12), device)
    if trans is not None:
        _check("trans", trans, (F, 3), device)
    out = torch.empty((F, V, 3), dtype=torch.float32, device=device)
    lib = native.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tpubody_fused_lbs(
            basis.data_ptr(), wT.data_ptr(), feat.data_ptr(), g.data_ptr(),
            None if trans is None else trans.data_ptr(), out.data_ptr(),
            F, V, K, J, int(precision == "bf16x3"), ctypes.c_void_p(stream))
    native.check(err, "fused_lbs launch")
    native.LAUNCHES["fused_lbs"] += 1
    return out


def lbs_forward_batch_fused(
    v_template: torch.Tensor,    # (V, 3)
    shapedirs: torch.Tensor,     # (V, 3, S)
    posedirs: torch.Tensor,      # (V, 3, P) with P = 9*(J-1)
    j_regressor: torch.Tensor,   # (J, V)
    weights: torch.Tensor,       # (V, J)
    parents: Sequence[int],
    poses: torch.Tensor,         # (F, J, 3) axis-angle or (F, J, 3, 3)
    beta: torch.Tensor,          # (S,) shared or (F, S) per-frame
    trans: Optional[torch.Tensor] = None,   # (F, 3)
    pose_is_rotmat: bool = False,
    kernel_precision: str = "highest",
    layouts: Optional[LBSLayouts] = None,
) -> torch.Tensor:
    """Batched LBS verts (F, V, 3) through :func:`fused_lbs` (same
    signature as ``tpubody``'s ``lbs_forward_batch_fused`` minus the TPU
    tile sizes).  Pass ``layouts`` to reuse a model's cached layouts."""
    if layouts is None:
        layouts = make_layouts(v_template, shapedirs, posedirs, j_regressor,
                               weights)
    feat, g = lbs_prologue(layouts, parents, poses, beta, pose_is_rotmat)
    if trans is not None:
        trans = trans.contiguous()
    return fused_lbs(layouts.basis, layouts.wT, feat, g, trans,
                     kernel_precision)
