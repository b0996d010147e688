"""HMR training step: supervised SMPL-parameter + keypoint regression
(port of ``tpubody.models.hmr_train``).

The standard HMR supervision: 2D keypoint reprojection under the
weak-perspective camera, plus SMPL pose / shape losses where ground truth
exists.  The model holds its parameters and BatchNorm statistics, the
optimizer its moments; a step updates both in place.  The optimizer is
``torch.optim.Adam`` with optax.adam's defaults (b1 0.9, b2 0.999, eps
1e-8 outside the square root, bias correction): the same update as the
``optax.adam(lr)`` of ``tpubody``'s ``train-hmr``.
:func:`from_optax_state` carries a ``tpubody`` optimizer state over, so a
run can move between the packages mid-training.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.models import hmr as hmr_lib
from tpubody_torch.models import smpl as smpl_lib
from tpubody_torch.models.params import BodyModelParams
from tpubody_torch.render import camera as camera_lib
from tpubody_torch.utils import pose_eval


class TrainBatch(NamedTuple):
    images: torch.Tensor        # (B, H, W, 3) normalized
    keypoints2d: torch.Tensor   # (B, K, 3) pixel x, y, conf (crop frame)
    has_smpl: torch.Tensor      # (B,) 1 where GT SMPL params exist
    gt_rotmats: torch.Tensor    # (B, 24, 3, 3)
    gt_shape: torch.Tensor      # (B, 10)

    def to(self, device, non_blocking: bool = False) -> "TrainBatch":
        return TrainBatch(*[torch.as_tensor(x).to(device,
                                                  non_blocking=non_blocking)
                            for x in self])


class TrainState(NamedTuple):
    model: hmr_lib.HMR
    optimizer: torch.optim.Optimizer
    step: int


def create_train_state(model: hmr_lib.HMR, lr: float = 1e-4) -> TrainState:
    """``model`` in train mode with an Adam optimizer over its parameters
    (in ``named_parameters`` order, which :func:`from_optax_state`
    relies on)."""
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return TrainState(model=model, optimizer=opt, step=0)


def _joints_and_verts(smpl_model: BodyModelParams, rotmats: torch.Tensor,
                      shape: torch.Tensor):
    state = smpl_lib.forward_batch(smpl_model, rotmats, shape, None,
                                   pose_is_rotmat=True)
    return smpl_lib.regress_joints(smpl_model, state.verts), state.verts


def loss_fn(
    model: hmr_lib.HMR,
    smpl_model: BodyModelParams,
    batch: TrainBatch,
    rng: Optional[torch.Generator],
    focal_length: float = 5000.0,
    img_size: float = 224.0,
    w_kp: float = 1.0, w_pose: float = 1.0, w_shape: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted loss and its parts {"kp", "pose", "shape"}.  Runs
    ``model`` as it is (train mode updates the BatchNorm statistics);
    ``rng`` draws the dropout masks."""
    out = model(batch.images, rng)

    # 2D keypoint reprojection under the weak-perspective camera.
    j3d, _ = _joints_and_verts(smpl_model, out.rotmats, out.shape)
    cam_t = camera_lib.weak_perspective_translation(
        out.cam, focal_length, img_size)
    proj = (j3d[..., :2] + cam_t[:, None, :2]) / torch.clamp(
        j3d[..., 2:3] + cam_t[:, None, 2:3], min=1e-2) * focal_length \
        + img_size / 2.0
    conf = batch.keypoints2d[..., 2:3]
    kp_loss = torch.mean(conf * torch.abs(proj - batch.keypoints2d[..., :2])
                         / img_size)

    # SMPL parameter supervision where available.
    has = batch.has_smpl
    m = has[:, None, None, None]
    pose_loss = torch.sum(m * (out.rotmats - batch.gt_rotmats) ** 2) \
        / torch.clamp(torch.sum(has) * 24 * 9, min=1.0)
    shape_loss = torch.sum(has[:, None] * (out.shape - batch.gt_shape) ** 2) \
        / torch.clamp(torch.sum(has) * 10, min=1.0)

    total = w_kp * kp_loss + w_pose * pose_loss + w_shape * shape_loss
    return total, {"kp": kp_loss, "pose": pose_loss, "shape": shape_loss}


def make_eval_step(smpl_model: BodyModelParams):
    """Returns ``eval_step(state, batch) -> metrics``: the field-standard 3D
    metrics (utils.pose_eval) against the batch's GT SMPL parameters:
    MPJPE / PA-MPJPE on regressed joints and PVE on vertices, all
    root-centered model-space (meters for real bodies).  Examples without
    GT (has_smpl=0) are masked out of the means.  The model runs in eval
    mode (running statistics, no dropout) and is put back as it was."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: TrainBatch):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            out = model(batch.images)
        finally:
            model.train(was_training)
        pred_j, pred_v = _joints_and_verts(smpl_model, out.rotmats,
                                           out.shape)
        gt_j, gt_v = _joints_and_verts(smpl_model, batch.gt_rotmats,
                                       batch.gt_shape)
        w = batch.has_smpl
        denom = torch.clamp(torch.sum(w), min=1.0)

        def mean(x):
            return torch.sum(w * x) / denom

        return {
            "mpjpe": mean(pose_eval.mpjpe(pred_j, gt_j)),
            "pa_mpjpe": mean(pose_eval.pa_mpjpe(pred_j, gt_j)),
            # PVE root-centered by each body's own root joint.
            "pve": mean(pose_eval.pve(pred_v - pred_j[:, :1],
                                      gt_v - gt_j[:, :1])),
        }

    return eval_step


def make_train_step(smpl_model: BodyModelParams, **loss_kw):
    """Returns ``step(state, batch, rng) -> (state, metrics)``: one Adam
    step on ``loss_fn`` in train mode.  The metrics stay on the device
    (reading them waits for the step)."""

    def train_step(state: TrainState, batch: TrainBatch,
                   rng: Optional[torch.Generator]):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, smpl_model, batch, rng,
                                **loss_kw)
        loss.backward()
        state.optimizer.step()
        return state._replace(step=state.step + 1), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}}

    return train_step


def from_optax_state(adam_state: Any, model: hmr_lib.HMR,
                     optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """A ``tpubody`` optax Adam state (``ScaleByAdamState`` or a mapping
    with ``count``, ``mu`` and ``nu``; numpy leaves, ``mu``/``nu`` shaped
    like the Flax ``params``) -> a state_dict for ``optimizer`` (an Adam
    over ``model.parameters()``, as :func:`create_train_state` builds)."""
    def get(key):
        return (adam_state[key] if isinstance(adam_state, Mapping)
                else getattr(adam_state, key))

    mu = hmr_lib.from_flax_variables({"params": get("mu")})
    nu = hmr_lib.from_flax_variables({"params": get("nu")})
    count = float(np.asarray(get("count")))
    names = [name for name, _ in model.named_parameters()]
    sd = optimizer.state_dict()
    ids = sd["param_groups"][0]["params"]
    if len(sd["param_groups"]) != 1 or len(ids) != len(names):
        raise ValueError("the optimizer must hold model.parameters() in one "
                         "group")
    state = {i: {"step": torch.tensor(count), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]} for i, name in zip(ids, names)}
    return {"state": state, "param_groups": sd["param_groups"]}
