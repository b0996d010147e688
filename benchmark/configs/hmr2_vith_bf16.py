"""hmr2_vith_bf16: HMR 2.0 (ViT-H/16 encoder, cross-attention decoder) and
SMPL through the port's ``HMRSMPLStep``, in bf16 (``hmr2_vith_bf16.json``)."""
from __future__ import annotations

import torch

from benchmark.models import hmr2_vith, hmr_smpl_step, smpl_body, vit_flops
from benchmark.reference import hmr2_smpl, hmr_smpl

PEAK = "bf16"


def widths(cfg: dict) -> dict:
    """The port's ``HMR2`` size arguments of the configuration."""
    if cfg["embed_dim"] != cfg["num_heads"] * cfg["head_dim"] or \
            cfg["context_dim"] != cfg["embed_dim"]:
        raise ValueError("embed_dim must be num_heads * head_dim and "
                         "context_dim")
    return {"image_size": cfg["image_size"], "crop_width": cfg["crop_width"],
            "patch_size": cfg["patch_size"], "dim": cfg["embed_dim"],
            "depth": cfg["depth"], "heads": cfg["num_heads"],
            "mlp_dim": cfg["mlp_dim"], "dec_dim": cfg["decoder_dim"],
            "dec_depth": cfg["decoder_depth"],
            "dec_heads": cfg["decoder_heads"],
            "dec_dim_head": cfg["decoder_dim_head"],
            "dec_mlp_dim": cfg["decoder_mlp_dim"]}


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """Weights in the types they are served in (the mean parameters among
    them), the body and the mean parameters, from ``seed`` on ``device``."""
    mean = hmr_smpl_step.mean_params(seed, device)
    weights = hmr2_vith.make(seed, device, cfg, mean)
    return {"weights": hmr2_vith.served(weights, torch.bfloat16),
            "body": smpl_body.make(seed, device, cfg["smpl_vertices"],
                                   cfg["smpl_joints"], cfg["n_betas"]),
            "mean": mean}


def build(cfg: dict, inputs: dict, device):
    from tpubody_torch.models import hmr2
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    with torch.device(device):
        model = hmr2.HMR2(inputs["mean"].cpu().numpy(), **widths(cfg))
    model = hmr2.to_compute(model, torch.bfloat16, device)
    hmr2.load_reference_state_dict(model, inputs["weights"])
    return HMRSMPLStep(model, hmr_smpl_step.body_params(inputs["body"]),
                       device, cfg["image_size"])


def layers(step):
    model = step.hmr

    def backbone(s):
        s["tokens"] = model.backbone(s["images"])

    def head(s):
        s["out"] = model.smpl_head(s["tokens"])

    return ([("hmr2.backbone", backbone), ("hmr2.head", head)]
            + hmr_smpl_step.lbs_layers(step))


def reference(cfg: dict, inputs: dict, control: bool = False):
    """images (N, H, W, 3) on the device -> (vertices, camera): float32, or
    for the control the patch convolution and every Linear in float8."""
    operand = hmr_smpl.fp8 if control else hmr_smpl.exact

    def run(images):
        return hmr2_smpl.forward(inputs["weights"], inputs["body"],
                                 smpl_body.SMPL_PARENTS, images, cfg,
                                 operand)
    return run


def flops_per_frame(cfg: dict) -> float:
    return vit_flops.hmr2_smpl_flops(cfg)
