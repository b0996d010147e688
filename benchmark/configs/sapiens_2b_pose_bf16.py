"""sapiens_2b_pose_bf16: Sapiens-2B pose (a ViT of 1,920 x 48 over 3,072
tokens in 32 heads of 60, a deconvolution heatmap head for Goliath's 308
keypoints) through the port's ``KeypointStep``, in bf16
(``sapiens_2b_pose_bf16.json``)."""
from __future__ import annotations

import torch

from benchmark.models import sapiens_flops, sapiens_vit
from benchmark.reference import hmr_smpl, sapiens_pose

PEAK = "bf16"


def widths(cfg: dict) -> dict:
    """The port's ``SapiensPose`` size arguments of the configuration."""
    if cfg["embed_dim"] != cfg["num_heads"] * cfg["head_dim"]:
        raise ValueError("embed_dim must be num_heads * head_dim")
    if cfg["patch_padding"] != 2 or cfg["deconv_kernel"] != 4 or \
            cfg["heatmap_stride"] * 4 != cfg["patch_size"]:
        raise ValueError("the port's Sapiens takes patch padding 2, "
                         "deconvolutions of 4 and heatmaps at a quarter of "
                         "a patch")
    return {"image_size": cfg["image_size"], "crop_width": cfg["crop_width"],
            "patch_size": cfg["patch_size"], "dim": cfg["embed_dim"],
            "depth": cfg["depth"], "heads": cfg["num_heads"],
            "mlp_dim": cfg["mlp_dim"],
            "deconv": tuple(cfg["deconv_channels"]),
            "conv": tuple(cfg["conv_channels"]),
            "keypoints": cfg["keypoints"]}


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The weights in the types they are served in, from ``seed`` on
    ``device``."""
    return {"weights": sapiens_vit.served(sapiens_vit.make(seed, device, cfg),
                                          torch.bfloat16)}


def build(cfg: dict, inputs: dict, device):
    from tpubody_torch.models import sapiens
    from tpubody_torch.pipelines.serving import KeypointStep

    with torch.device(device):
        model = sapiens.SapiensPose(**widths(cfg))
    model = sapiens.to_compute(model, torch.bfloat16, device)
    sapiens.load_reference_state_dict(model, inputs["weights"])
    return KeypointStep(model, device, cfg["image_size"])


def layers(step):
    """The step's layers: the encoder, the heatmap head, the decode (the
    answers under the names the harness copies out)."""
    model = step.model

    def backbone(s):
        s["tokens"] = model.backbone(s["images"])

    def head(s):
        s["logits"] = model.head(s["tokens"])

    def decode(s):
        s["verts"], s["cam"] = model.decode(s["logits"])

    return [("sapiens.backbone", backbone), ("sapiens.head", head),
            ("sapiens.decode", decode)]


def reference(cfg: dict, inputs: dict, control: bool = False):
    """images (N, H, W, 3) on the device -> (keypoints (N, K, 2),
    confidences (N, K)): float32, or for the control the patch convolution,
    every Linear and every convolution of the head in float8."""
    operand = hmr_smpl.fp8 if control else hmr_smpl.exact

    def run(images):
        return sapiens_pose.forward(inputs["weights"], images, cfg, operand)
    return run


def flops_per_frame(cfg: dict) -> float:
    return sapiens_flops.sapiens_pose_flops(cfg)
