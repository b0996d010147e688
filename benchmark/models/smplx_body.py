"""A seeded body at SMPL-X's shapes (Pavlakos et al., CVPR 2019,
arXiv:1904.05866), made on the device.

The SMPL-X asset is not in the repository.  This stands in for it with the
same tensors and sizes: 10,475 vertices, 55 joints on SMPL-X's kinematic
tree (22 body joints, the jaw and the two eyes under the head, 15 joints of
each hand under its wrist), 10 shape, 10 expression and 486 pose blend
shapes, skinning weights whose rows sum to 1 (a soft assignment to the
nearby joints) and a joint regressor that averages the vertices around each
joint.  The expression directions act on the vertices of the head, the jaw
and the eyes, and a hundredth as much elsewhere, as SMPL-X's face
expressions do.  The skinned step reads no faces.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark import seeding

# SMPL-X's kinematic tree: the parent of each of its 55 joints.
SMPLX_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    15, 15, 15,
    20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
    21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53)
FACE_JOINTS = (15, 22, 23, 24)
BONE_SCALE = 0.12
HAND_BONE_SCALE = 0.03


@torch.no_grad()
def make(seed: int, device, n_verts: int = 10475, n_joints: int = 55,
         n_betas: int = 10, n_expression: int = 10) -> Dict[str, torch.Tensor]:
    """v_template (V, 3), shapedirs (V, 3, S), expr_dirs (V, 3, E),
    posedirs (V, 3, 9 (J - 1)), j_regressor (J, V), weights (V, J);
    float32 on ``device``."""
    if n_joints != len(SMPLX_PARENTS):
        raise ValueError(f"SMPL-X's tree has {len(SMPLX_PARENTS)} joints")
    gen = seeding.generator(seed, "smplx_body", device)
    n_pose = 9 * (n_joints - 1)
    scale = torch.full((n_joints, 1), BONE_SCALE, device=device)
    scale[25:] = HAND_BONE_SCALE
    offsets = scale * torch.randn((n_joints, 3), generator=gen,
                                  device=device)
    joints = [offsets[0]]
    for i in range(1, n_joints):
        joints.append(joints[SMPLX_PARENTS[i]] + offsets[i])
    joints = torch.stack(joints)
    owner = torch.randint(0, n_joints, (n_verts,), generator=gen,
                          device=device)
    widths = (3, 3 * n_betas, 3 * n_expression, 3 * n_pose)
    noise = torch.randn((n_verts, sum(widths)), generator=gen, device=device)
    v, s, e, p = torch.split(noise, widths, dim=1)
    v_template = joints[owner] + 0.05 * v
    shapedirs = 0.01 * s.reshape(n_verts, 3, n_betas)
    face = torch.isin(owner, torch.tensor(FACE_JOINTS, device=device))
    expr_dirs = 0.01 * e.reshape(n_verts, 3, n_expression) * torch.where(
        face, 1.0, 0.01)[:, None, None]
    posedirs = 0.005 * p.reshape(n_verts, 3, n_pose)
    d2 = torch.cdist(v_template, joints) ** 2
    weights = torch.softmax(-d2 / (2 * 0.06 ** 2), dim=1)
    one_hot = torch.nn.functional.one_hot(owner, n_joints).float().t()
    j_regressor = one_hot / one_hot.sum(dim=1, keepdim=True).clamp(min=1.0)
    return {"v_template": v_template.contiguous(),
            "shapedirs": shapedirs.contiguous(),
            "expr_dirs": expr_dirs.contiguous(),
            "posedirs": posedirs.contiguous(),
            "j_regressor": j_regressor.contiguous(),
            "weights": weights.contiguous()}
