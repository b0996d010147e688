"""hmr_r50_spin_bf16: HMR (ResNet-50 + IEF) and SMPL through the port's
``HMRSMPLStep``, the backbone in bf16 (``hmr_r50_spin_bf16.json``)."""
from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.models import hmr_r50, hmr_smpl_step, smpl_body
from benchmark.reference import hmr_smpl

PEAK = "bf16"


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """Weights in the types they are served in, the body and the mean
    parameters, from ``seed`` on ``device``."""
    weights = hmr_r50.make(seed, device, tuple(cfg["stage_sizes"]))
    return {"weights": hmr_r50.served(weights, torch.bfloat16),
            "body": smpl_body.make(seed, device, cfg["smpl_vertices"],
                                   cfg["smpl_joints"], cfg["n_betas"]),
            "mean": hmr_smpl_step.mean_params(seed, device)}


def build(cfg: dict, inputs: dict, device):
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    model = hmr_smpl_step.load_hmr(cfg, inputs["weights"], inputs["mean"],
                                   torch.bfloat16, device)
    return HMRSMPLStep(model, hmr_smpl_step.body_params(inputs["body"]),
                       device, cfg["image_size"])


def layers(step):
    def backbone(s):
        s["feats"] = step.hmr.backbone(s["images"])

    def head(s):
        s["out"] = step.hmr.ief(s["feats"])

    return ([("hmr.backbone", backbone), ("hmr.ief", head)]
            + hmr_smpl_step.lbs_layers(step))


def reference(cfg: dict, inputs: dict, control: bool = False):
    """images (N, H, W, 3) on the device -> (vertices, camera): float32, or
    for the control the convolutions, fc1 and fc2 in float8."""
    operand = hmr_smpl.fp8 if control else hmr_smpl.exact

    def run(images):
        return hmr_smpl.forward(inputs["weights"], inputs["body"],
                                smpl_body.SMPL_PARENTS, inputs["mean"],
                                images, cfg["stage_sizes"],
                                cfg["ief_iterations"], operand)
    return run


def flops_per_frame(cfg: dict) -> float:
    return roofline.hmr_smpl_flops(cfg)
