"""Linear blend skinning (forward + inverse) and forward kinematics.

Port of ``tpubody.core.lbs``.  Functions take arbitrary leading batch
dimensions (the JAX package writes them unbatched and ``vmap``s them):
``lbs`` with poses (F, J, 3) and betas (S,) or (F, S) is the batched
forward.  Every contraction is an fp32 ``matmul``/``einsum``; on CUDA they
stay full fp32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is
False (PyTorch's default).  The kinematic chain is a static Python loop
over the joint tree.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from tpubody_torch.core.rotations import rodrigues


class LBSOutput(NamedTuple):
    """Outputs of one LBS forward pass."""

    verts: torch.Tensor           # (..., V, 3) posed vertices (+ translation)
    joints: torch.Tensor          # (..., J, 3) rest-pose joint locations
    joints_posed: torch.Tensor    # (..., J, 3) posed joint locations
    rel_transforms: torch.Tensor  # (..., J, 4, 4) rest-relative transforms
    v_posed: torch.Tensor         # (..., V, 3) blendshaped rest vertices


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n, m) x (..., m) -> (..., n), broadcasting the batch dims."""
    return torch.matmul(M, v[..., None])[..., 0]


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Homogeneous transforms from rotations (..., 3, 3) and translations
    (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def forward_kinematics(
    R: torch.Tensor, joints: torch.Tensor, parents: Sequence[int]
) -> torch.Tensor:
    """Compose local joint rotations along the kinematic tree.

    Args:
      R: (..., J, 3, 3) local rotations per joint.
      joints: (..., J, 3) rest-pose joint positions (broadcast against R).
      parents: length-J static parent indices; parents[0] is ignored.

    Returns:
      (..., J, 4, 4) world transforms, G[0] = [R0 | j0],
      G[i] = G[parent[i]] @ [Ri | j_i - j_parent].
    """
    J = len(parents)
    parr = [0] + [int(p) for p in parents[1:]]
    rel_t = joints - joints[..., parr, :]
    rel_t = torch.cat([joints[..., :1, :], rel_t[..., 1:, :]], dim=-2)
    rel_t = rel_t.expand(R.shape[:-2] + (3,))
    A = make_se3(R, rel_t)  # local transforms (..., J, 4, 4)
    G = [A[..., 0, :, :]]
    for i in range(1, J):
        G.append(torch.matmul(G[parents[i]], A[..., i, :, :]))
    return torch.stack(G, dim=-3)


def remove_rest_pose(G: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """World joint transforms -> rest-relative skinning transforms: the
    rotation block is kept and the translation becomes ``t - R_g @ j``."""
    Rg = G[..., :3, :3]
    t = G[..., :3, 3]
    return make_se3(Rg, t - _matvec(Rg, joints))


def affine_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of affine 4x4 matrices [M t; 0 1], with M a
    blend of rotations inverted by its 3x3 adjugate."""
    M = T[..., :3, :3]
    t = T[..., :3, 3]
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    r0 = torch.linalg.cross(c1, c2, dim=-1)
    r1 = torch.linalg.cross(c2, c0, dim=-1)
    r2 = torch.linalg.cross(c0, c1, dim=-1)
    det = torch.sum(c0 * r0, dim=-1, keepdim=True)[..., None]
    Minv = torch.stack([r0, r1, r2], dim=-2) / det
    return make_se3(Minv, -_matvec(Minv, t))


def blend_transforms(weights: torch.Tensor, G_rel: torch.Tensor) -> torch.Tensor:
    """Per-vertex blended transforms: weights (V, J) x G_rel (..., J, 4, 4)
    -> (..., V, 4, 4), one (V, J) x (J, 16) product per batch element."""
    flat = G_rel.reshape(G_rel.shape[:-2] + (16,))
    T = torch.matmul(weights, flat)
    return T.reshape(T.shape[:-1] + (4, 4))


def apply_transforms(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Per-point affine transforms: (..., V, 4, 4) x (..., V, 3) -> (..., V, 3)."""
    return _matvec(T[..., :3, :3], pts) + T[..., :3, 3]


def lbs(
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    j_regressor: torch.Tensor,
    weights: torch.Tensor,
    parents: Sequence[int],
    pose: torch.Tensor,
    beta: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
    pose_is_rotmat: bool = False,
) -> LBSOutput:
    """Full SMPL-family LBS forward pass.

    Args:
      v_template: (V, 3).  shapedirs: (V, 3, S).  posedirs: (V, 3, 9*(J-1)).
      j_regressor: (J, V).  weights: (V, J).  parents: static tree.
      pose: (..., J, 3) axis-angle, or (..., J, 3, 3) if ``pose_is_rotmat``.
      beta: (..., S) shape coefficients, broadcast against pose's batch.
      trans: optional (..., 3) global translation.
    """
    J = len(parents)
    v_shaped = v_template + torch.einsum("vcs,...s->...vc", shapedirs, beta)
    joints = torch.matmul(j_regressor, v_shaped)
    R = pose if pose_is_rotmat else rodrigues(pose)
    batch = R.shape[:-3]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    pose_feat = (R[..., 1:, :, :] - eye).reshape(batch + (9 * (J - 1),))
    v_posed = v_shaped + torch.einsum("vcp,...p->...vc", posedirs, pose_feat)

    G = forward_kinematics(R, joints, parents)
    G_rel = remove_rest_pose(G, joints)
    T = blend_transforms(weights, G_rel)
    verts = apply_transforms(T, v_posed)
    if trans is not None:
        verts = verts + trans[..., None, :]
    return LBSOutput(
        verts=verts,
        joints=joints.expand(batch + joints.shape[-2:]),
        joints_posed=G[..., :3, 3],
        rel_transforms=G_rel,
        v_posed=v_posed.expand(batch + v_posed.shape[-2:]),
    )


def skin(
    v_template: torch.Tensor,     # (V, 3) rest-pose vertices
    weights: torch.Tensor,        # (V, J)
    joints: torch.Tensor,         # (J, 3) rest-pose joint locations
    parents: Sequence[int],
    pose: torch.Tensor,           # (..., J, 3) axis-angle
    trans: Optional[torch.Tensor] = None,   # (..., 3)
) -> torch.Tensor:
    """Skin a rigged template with explicit joints (no regressor or
    blendshapes): the per-frame animation transform of rigged avatars."""
    R = rodrigues(pose)
    G = forward_kinematics(R, joints, parents)
    G_rel = remove_rest_pose(G, joints)
    T = blend_transforms(weights, G_rel)
    verts = apply_transforms(T, v_template)
    if trans is not None:
        verts = verts + trans[..., None, :]
    return verts


def skin_batch(
    v_template: torch.Tensor,   # (V, 3)
    weights: torch.Tensor,      # (V, J)
    joints: torch.Tensor,       # (J, 3)
    parents: Sequence[int],
    poses: torch.Tensor,        # (F, J, 3)
    trans: Optional[torch.Tensor] = None,  # (F, 3)
) -> torch.Tensor:
    """F frames skinned in one batched pass -> (F, V, 3)."""
    return skin(v_template, weights, joints, parents, poses, trans)


def inverse_lbs(
    verts: torch.Tensor,
    weights: torch.Tensor,
    G_rel: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Un-pose vertices: the inverse of :func:`lbs` skinning, returning the
    rest-pose (blendshaped) vertices for the pose's rest-relative
    transforms."""
    if trans is not None:
        verts = verts - trans[..., None, :]
    T = blend_transforms(weights, G_rel)
    return apply_transforms(affine_inverse(T), verts)
