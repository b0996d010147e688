"""multihmr_896_l_bf16: Multi-HMR 896-L (DINOv2 ViT-L/14 over 4,097 tokens, a
cross-attention human head) and SMPL-X through the port's ``HMRSMPLStep``,
in bf16, 8 given persons a frame (``multihmr_896_l_bf16.json``)."""
from __future__ import annotations

import numpy as np
import torch

from benchmark.models import dinov2_flops, multihmr_vitl, smplx_body
from benchmark.reference import hmr_smpl, multihmr_smplx

PEAK = "bf16"


def widths(cfg: dict) -> dict:
    """The port's ``MultiHMR`` size arguments of the configuration."""
    grid = cfg["image_size"] // cfg["patch_size"]
    if cfg["embed_dim"] != cfg["num_heads"] * cfg["head_dim"] or \
            cfg["context_dim"] != cfg["embed_dim"] + 3 + 6 * cfg["ray_bands"]:
        raise ValueError("embed_dim must be num_heads * head_dim and "
                         "context_dim embed_dim + the ray encoding's width")
    if len(cfg["centres"]) != cfg["persons"] or \
            not all(0 <= c < grid * grid for c in cfg["centres"]):
        raise ValueError(f"centres: {cfg['persons']} patch indices on the "
                         f"{grid} x {grid} grid")
    return {"image_size": cfg["image_size"], "patch_size": cfg["patch_size"],
            "dim": cfg["embed_dim"], "depth": cfg["depth"],
            "heads": cfg["num_heads"], "mlp_dim": cfg["mlp_dim"],
            "pos_grid": cfg["pos_embed_grid"], "fov_deg": cfg["fov_deg"],
            "ray_bands": cfg["ray_bands"],
            "ray_max_resolution": cfg["ray_max_resolution"],
            "head_dim": cfg["hph_dim"], "head_depth": cfg["hph_depth"],
            "head_heads": cfg["hph_heads"],
            "head_dim_head": cfg["hph_dim_head"],
            "head_mlp_dim": cfg["hph_mlp_dim"],
            "centres": tuple(cfg["centres"])}


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """Weights in the types they are served in (the mean parameters among
    them), the body and the mean parameters, from ``seed`` on ``device``."""
    mean = multihmr_vitl.mean_params(seed, device, cfg)
    weights = multihmr_vitl.make(seed, device, cfg, mean)
    return {"weights": multihmr_vitl.served(weights, torch.bfloat16),
            "body": smplx_body.make(seed, device, cfg["smpl_vertices"],
                                    cfg["smpl_joints"], cfg["n_betas"],
                                    cfg["n_expression"]),
            "mean": mean}


def body_params(body: dict):
    """The benchmark's seeded body as the port's ``BodyModelParams``."""
    from tpubody_torch.models.params import BodyModelParams

    return BodyModelParams(parents=smplx_body.SMPLX_PARENTS,
                           faces=np.zeros((0, 3), np.int64), **body)


def build(cfg: dict, inputs: dict, device):
    from tpubody_torch.models import multihmr
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    with torch.device(device):
        model = multihmr.MultiHMR(inputs["mean"].cpu().numpy(),
                                  **widths(cfg))
    model = multihmr.to_compute(model, torch.bfloat16, device)
    multihmr.load_reference_state_dict(model, inputs["weights"])
    return HMRSMPLStep(model, body_params(inputs["body"]), device,
                       cfg["image_size"])


def layers(step):
    """The step's layers: the encoder, the head, then the skinning as the
    step runs it (the LBS prologue and the translation, then the fused
    kernel), the answers shaped (frames, persons, ...)."""
    from tpubody_torch.core import fused_lbs

    model, body = step.hmr, step.body
    n_shape = body.num_betas + body.num_expressions
    layouts = fused_lbs.model_layouts(body, n_shape)

    def backbone(s):
        s["tokens"] = model.backbone(s["images"])

    def head(s):
        s["out"] = model.head(s["tokens"])

    def prologue(s):
        out = s["out"]
        s["feat"], s["g"] = fused_lbs.lbs_prologue(
            layouts, body.parents, out.rotmats, out.shape,
            pose_is_rotmat=True)
        s["transl"] = (out.cam - fused_lbs.posed_joint(
            layouts, s["g"], out.shape, model.anchor_joint)).contiguous()

    def kernel(s):
        verts = fused_lbs.fused_lbs(layouts, s["feat"], s["g"], s["transl"],
                                    "bf16x3")
        s["verts"] = verts.view(-1, model.persons, *verts.shape[1:])
        s["cam"] = s["transl"].view(-1, model.persons, 3)

    return [("multihmr.backbone", backbone), ("multihmr.head", head),
            ("lbs.prologue", prologue), ("fused_lbs", kernel)]


def reference(cfg: dict, inputs: dict, control: bool = False):
    """images (N, H, W, 3) on the device -> (vertices (N, P, V, 3),
    translation (N, P, 3)): float32, or for the control the patch
    convolution and every Linear in float8."""
    operand = hmr_smpl.fp8 if control else hmr_smpl.exact

    def run(images):
        return multihmr_smplx.forward(inputs["weights"], inputs["body"],
                                      smplx_body.SMPLX_PARENTS, images, cfg,
                                      operand)
    return run


def flops_per_frame(cfg: dict) -> float:
    return dinov2_flops.multihmr_smplx_flops(cfg)
