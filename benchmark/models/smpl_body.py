"""A seeded body at SMPL's shapes (Loper et al. 2015), made on the device.

The SMPL asset is not in the repository.  This stands in for it with the
same tensors and sizes: 6890 vertices, 24 joints on SMPL's kinematic tree,
10 shape and 207 pose blend shapes, skinning weights whose rows sum to 1
(a soft assignment to the nearby joints) and a joint regressor that
averages the vertices around each joint.  The skinned step reads no faces.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark import seeding

# SMPL's kinematic tree: the parent of each of its 24 joints.
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16,
                17, 18, 19, 20, 21)


@torch.no_grad()
def make(seed: int, device, n_verts: int = 6890, n_joints: int = 24,
         n_betas: int = 10) -> Dict[str, torch.Tensor]:
    """v_template (V, 3), shapedirs (V, 3, S), posedirs (V, 3, 9 (J - 1)),
    j_regressor (J, V), weights (V, J); float32 on ``device``."""
    if n_joints != len(SMPL_PARENTS):
        raise ValueError(f"SMPL's tree has {len(SMPL_PARENTS)} joints")
    gen = seeding.generator(seed, "smpl_body", device)
    n_pose = 9 * (n_joints - 1)
    offsets = 0.12 * torch.randn((n_joints, 3), generator=gen, device=device)
    joints = [offsets[0]]
    for i in range(1, n_joints):
        joints.append(joints[SMPL_PARENTS[i]] + offsets[i])
    joints = torch.stack(joints)
    owner = torch.randint(0, n_joints, (n_verts,), generator=gen,
                          device=device)
    noise = torch.randn((n_verts, 3 + 3 * n_betas + 3 * n_pose),
                        generator=gen, device=device)
    v_template = joints[owner] + 0.05 * noise[:, :3]
    shapedirs = 0.01 * noise[:, 3:3 + 3 * n_betas].reshape(n_verts, 3,
                                                            n_betas)
    posedirs = 0.005 * noise[:, 3 + 3 * n_betas:].reshape(n_verts, 3, n_pose)
    d2 = torch.cdist(v_template, joints) ** 2
    weights = torch.softmax(-d2 / (2 * 0.06 ** 2), dim=1)
    one_hot = torch.nn.functional.one_hot(owner, n_joints).float().t()
    j_regressor = one_hot / one_hot.sum(dim=1, keepdim=True).clamp(min=1.0)
    return {"v_template": v_template.contiguous(),
            "shapedirs": shapedirs.contiguous(),
            "posedirs": posedirs.contiguous(),
            "j_regressor": j_regressor.contiguous(),
            "weights": weights.contiguous()}
