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

The per-model layouts (basis (3, K, V), weights (J, V), joint bases, and
the kernel's bf16 planes of basis and weights) are computed once per body
model and cached on it (:func:`model_layouts`).  The kernel's entry point
splits the per-frame rows feat and g the same way on the card, in a pass
of its own before the products.

``fused_lbs`` launches the kernel for CUDA tensors and raises if it
cannot; it uses :func:`fused_lbs_reference`, the same arithmetic in plain
torch ops, only for tensors on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from tpubody_torch import native
from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.core.rotations import rodrigues
from tpubody_torch.utils.profiling import span

PRECISIONS = ("highest", "bf16x3")
TILE = 64    # frames and vertices a block of the kernel covers


class LBSLayouts(NamedTuple):
    """Per-model constants: the plain version's fp32 matrices and the
    kernel's split planes."""

    basis: torch.Tensor        # (3, K, V): [posedirs | shapedirs | v_template]
    wT: torch.Tensor           # (J, V) skinning weights, transposed
    base_joints: torch.Tensor  # (J, 3)  j_regressor @ v_template
    j_shape: torch.Tensor      # (J, 3, S) j_regressor @ shapedirs
    planes: torch.Tensor       # (3, Vp / 16, 3 * KS + JS, 32, 8) bf16


def _ksteps(n: int) -> int:
    return (n + 15) // 16


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def split_planes(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` -> (3, *x.shape) bf16 planes hi, lo, lo2: hi = bf16(x),
    lo = bf16(x - hi), lo2 = bf16(x - hi - lo) (each difference exact in
    fp32), so |x - hi - lo - lo2| <= 2^-24 |x|.  hi and lo are
    :func:`_split_bf16`'s parts bit for bit."""
    x = x.float()
    planes = torch.empty((3,) + tuple(x.shape), dtype=torch.bfloat16,
                         device=x.device)
    planes[0] = x                       # each assignment rounds to nearest
    r = x - planes[0]                   # bf16 widened exactly: f32 difference
    planes[1] = r
    planes[2] = r - planes[1]
    return planes


def pack_vertex_planes(basis: torch.Tensor, wT: torch.Tensor) -> torch.Tensor:
    """The model's matrices as the kernel's B operand (columns: vertices),
    split once: (3, K, V) basis and (J, V) weights -> (3 planes, Vp / 16,
    3 * KS + JS items, 32 lanes, 8) bf16, with K and J padded with zeros to
    16 * KS and 16 * JS and V to Vp, a multiple of 64.  Item c * KS + s is
    k step s of coordinate c, item 3 * KS + s k step s of the weights.  The
    8 values of lane (g, t) are the mma.sync m16n8k16 B fragments (b0, b1)
    of column tiles 0 and 1 of the 16 vertices: value ntile * 4 + kh * 2 +
    half is row k = kh * 8 + 2 * t + half, vertex ntile * 8 + g."""
    _, K, V = basis.shape
    J = wT.shape[0]
    KS, JS = _ksteps(K), _ksteps(J)
    Vp = _round_up(V, TILE)
    m = basis.new_zeros((16 * (3 * KS + JS), Vp), dtype=torch.float32)
    for c in range(3):
        m[16 * KS * c:16 * KS * c + K, :V] = basis[c]
    m[48 * KS:48 * KS + J, :V] = wT
    p = split_planes(m).view(3, 3 * KS + JS, 2, 4, 2, Vp // 16, 2, 8)
    return p.permute(0, 5, 1, 7, 3, 6, 2, 4).reshape(
        3, Vp // 16, 3 * KS + JS, 32, 8).contiguous()


def model_layouts(model, n_shape: Optional[int] = None) -> LBSLayouts:
    """The kernel layouts of ``model`` (a ``BodyModelParams``) for
    ``n_shape`` shape coefficients a frame (``model.shape_basis``: the
    betas by default, betas ⊕ expression on a body with ``expr_dirs``),
    computed on first use and cached on the model."""
    n = model.num_betas if n_shape is None else n_shape
    key = "fused_lbs" if n == model.num_betas else f"fused_lbs.shape{n}"
    cached = model.cache.get(key)
    if cached is None:
        cached = make_layouts(model.v_template, model.shape_basis(n),
                              model.posedirs, model.j_regressor,
                              model.weights)
        model.cache[key] = cached
    return cached


def make_layouts(v_template, shapedirs, posedirs, j_regressor,
                 weights) -> LBSLayouts:
    """Kernel layouts from the raw model tensors (V, 3), (V, 3, S),
    (V, 3, P), (J, V), (V, J)."""
    basis = torch.cat([posedirs, shapedirs, v_template[:, :, None]], dim=2)
    basis = basis.permute(1, 2, 0).contiguous()
    wT = weights.t().contiguous()
    return LBSLayouts(
        basis=basis,
        wT=wT,
        base_joints=torch.matmul(j_regressor, v_template),
        j_shape=torch.einsum("jv,vcs->jcs", j_regressor, shapedirs),
        planes=pack_vertex_planes(basis, wT),
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


def posed_joint(layouts: LBSLayouts, g: torch.Tensor, beta: torch.Tensor,
                joint: int) -> torch.Tensor:
    """Where joint ``joint`` of the posed body lies before any translation
    -> (F, 3): its rest place ``j`` on the shaped template moved by its
    transform in :func:`lbs_prologue`'s ``g``, ``[R | t - R j]``.  beta as
    :func:`lbs_prologue` takes it."""
    F = g.shape[0]
    betas_f = beta.expand(F, -1) if beta.dim() == 1 else beta
    rest = layouts.base_joints[joint] + torch.einsum(
        "cs,fs->fc", layouts.j_shape[joint], betas_f)
    G = g[:, joint].view(F, 3, 4)
    return torch.einsum("fab,fb->fa", G[..., :3], rest) + G[..., 3]


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


def fused_lbs(layouts: LBSLayouts, feat: torch.Tensor, g: torch.Tensor,
              trans: Optional[torch.Tensor] = None,
              precision: str = "bf16x3") -> torch.Tensor:
    """Fused LBS -> verts (F, V, 3).

    ``layouts`` from :func:`model_layouts`; feat (F, K), g (F, J, 12) from
    :func:`lbs_prologue` and trans (F, 3) or None, float32 and contiguous.
    On CUDA the kernel reads the model's planes and splits the frames'
    rows into planes of its own (or this raises); on the CPU
    :func:`fused_lbs_reference` takes the fp32 matrices."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    device = layouts.basis.device
    if device.type == "cpu":
        return fused_lbs_reference(layouts.basis, layouts.wT, feat, g, trans,
                                   precision)
    if device.type != "cuda":
        raise ValueError(f"fused_lbs runs on CUDA or CPU tensors, got {device}")
    K, V = layouts.basis.shape[1], layouts.basis.shape[2]
    J, F = layouts.wT.shape[0], feat.shape[0]
    KS, JS = _ksteps(K), _ksteps(J)
    f32 = torch.float32
    native.expect("layouts.planes", layouts.planes,
                  (3, _round_up(V, TILE) // 16, 3 * KS + JS, 32, 8),
                  torch.bfloat16, device)
    native.expect("feat", feat, (F, K), f32, device)
    native.expect("g", g, (F, J, 12), f32, device)
    if trans is not None:
        native.expect("trans", trans, (F, 3), f32, device)
    out = torch.empty((F, V, 3), dtype=torch.float32, device=device)
    # the frames' planes: hi, lo (and lo2 for "highest"), filled by the kernel
    frm = torch.empty((2 if precision == "bf16x3" else 3,
                       _round_up(F, TILE) // 16, KS + 12 * JS, 32, 8),
                      dtype=torch.bfloat16, device=device)
    native.launch("fused_lbs", "tpubody_fused_lbs", device,
                  layouts.planes.data_ptr(), feat.data_ptr(), g.data_ptr(),
                  frm.data_ptr(), None if trans is None else trans.data_ptr(),
                  out.data_ptr(), F, V, K, J, int(precision == "bf16x3"))
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
    with span("lbs.prologue"):
        feat, g = lbs_prologue(layouts, parents, poses, beta, pose_is_rotmat)
    with span("fused_lbs"):
        if trans is not None:
            trans = trans.contiguous()
        return fused_lbs(layouts, feat, g, trans, kernel_precision)
