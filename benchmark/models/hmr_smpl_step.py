"""What the HMR + SMPL configurations share: the mean parameters, the port's
HMR and body loaded with the benchmark's seeded inputs, and the layers of
``HMRSMPLStep`` from the IEF head's output down to the vertices.

The port (``tpubody_torch``) is imported inside the functions, so that the
harness's own modules import without it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark import seeding
from benchmark.models import smpl_body

Layer = Tuple[str, Callable[[dict], None]]


MEAN_POSE_RADIANS = 0.4


@torch.no_grad()
def mean_params(seed: int, device) -> torch.Tensor:
    """(157,) the regressor's starting point: a seeded mean pose, zero
    betas, camera (0.9, 0, 0).  SPIN's ``smpl_mean_params.npz`` is not in
    the repository.  The mean pose turns each joint about a random axis by
    an angle of about ``MEAN_POSE_RADIANS``, as a person's average pose
    bends the limbs.  A 6D rotation is the first two columns of its matrix
    read as (3, 2) (the identity is (1, 0, 0, 1, 0, 0)), so each starts from
    two orthonormal columns and the regressor's updates stay far from the
    degenerate 6D vectors."""
    gen = seeding.generator(seed, "mean_params", device)
    aa = MEAN_POSE_RADIANS * torch.randn((24, 3), generator=gen,
                                         device=device)
    angle = aa.norm(dim=1, keepdim=True)
    k = aa / angle
    K = torch.zeros((24, 3, 3), device=device)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(1, 2)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    R = torch.eye(3, device=device) + s * K + (1 - c) * (K @ K)
    pose6d = R[:, :, :2].reshape(-1)
    return torch.cat([pose6d, torch.zeros(10, device=device),
                      torch.tensor([0.9, 0.0, 0.0], device=device)])


def load_hmr(cfg: dict, weights: Dict[str, torch.Tensor], mean: torch.Tensor,
             dtype: torch.dtype, device: torch.device):
    """The port's HMR with the benchmark's weights, in the compute ``dtype``
    (the backbone's convolutions, fc1 and fc2), eval mode, on ``device``."""
    from tpubody_torch.models import hmr as hmr_lib

    with torch.device(device):
        model = hmr_lib.HMR(mean.cpu().numpy(), n_iter=cfg["ief_iterations"],
                            stage_sizes=tuple(cfg["stage_sizes"]))
    hmr_lib.load_reference_state_dict(model, weights)
    return hmr_lib.to_compute(model, dtype, device)


def body_params(body: Dict[str, torch.Tensor]):
    """The benchmark's seeded body as the port's ``BodyModelParams``."""
    from tpubody_torch.models.params import BodyModelParams

    return BodyModelParams(parents=smpl_body.SMPL_PARENTS,
                           faces=np.zeros((0, 3), np.int64), **body)


def lbs_layers(step) -> List[Layer]:
    """``HMRSMPLStep``'s skinning, as two layers: the per-frame prologue
    (torch ops) and the fused kernel, with the arguments the step gives
    them."""
    from tpubody_torch.core import fused_lbs

    layouts = fused_lbs.model_layouts(step.body)

    def prologue(s):
        s["feat"], s["g"] = fused_lbs.lbs_prologue(
            layouts, step.body.parents, s["out"].rotmats, s["out"].shape,
            pose_is_rotmat=True)

    def kernel(s):
        s["verts"] = fused_lbs.fused_lbs(layouts, s["feat"], s["g"], None,
                                         "bf16x3")
        s["cam"] = s["out"].cam

    return [("lbs.prologue", prologue), ("fused_lbs", kernel)]
