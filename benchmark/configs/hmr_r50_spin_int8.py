"""hmr_r50_spin_int8: the same model through the port's int8 post-training
quantization (``hmr_quant.quantize_hmr`` then ``QuantizedHMR``, as
``hmr_smpl_step(quantize=True)`` builds it) and ``HMRSMPLStep``
(``hmr_r50_spin_int8.json``)."""
from __future__ import annotations

import torch

from benchmark import generate, roofline
from benchmark.models import hmr_r50, hmr_smpl_step, smpl_body
from benchmark.reference import hmr_int8

PEAK = "int8"


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """float32 weights, the body, the mean parameters and the calibration
    images, from ``seed`` on ``device``."""
    calib = cfg["calibration"]
    return {"weights": hmr_r50.make(seed, device, tuple(cfg["stage_sizes"])),
            "body": smpl_body.make(seed, device, cfg["smpl_vertices"],
                                   cfg["smpl_joints"], cfg["n_betas"]),
            "mean": hmr_smpl_step.mean_params(seed, device),
            "calib": generate.images(calib["images"], calib["count"],
                                     cfg["image_size"], seed, "calibration",
                                     device)}


def build(cfg: dict, inputs: dict, device):
    from tpubody_torch.models import hmr_quant
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    model = hmr_smpl_step.load_hmr(cfg, inputs["weights"], inputs["mean"],
                                   torch.float32, device)
    qmodel = hmr_quant.QuantizedHMR(
        hmr_quant.quantize_hmr(model, inputs["calib"]),
        mean_params=inputs["mean"].cpu().numpy(),
        n_iter=cfg["ief_iterations"])
    return HMRSMPLStep(qmodel, hmr_smpl_step.body_params(inputs["body"]),
                       device, cfg["image_size"])


def layers(step):
    from tpubody_torch.models import hmr_quant

    q = step.hmr

    def backbone(s):
        s["feats"] = hmr_quant._backbone_int8(q.qparams, s["images"])

    def head(s):
        s["out"] = hmr_quant._ief_head(q.qparams["head"], s["feats"],
                                       q.mean_params, q.n_iter)

    return ([("hmr_quant.backbone", backbone), ("hmr_quant.ief", head)]
            + hmr_smpl_step.lbs_layers(step))


def reference(cfg: dict, inputs: dict, control: bool = False):
    """images (N, H, W, 3) on the device -> (vertices, camera) of the
    quantized network worked out again from the float32 weights: int8, or
    int4 for the control."""
    bits = 4 if control else 8
    stages = cfg["stage_sizes"]
    qparams = hmr_int8.prepare(inputs["weights"], inputs["calib"], stages,
                               bits)

    def run(images):
        return hmr_int8.forward(qparams, inputs["weights"], inputs["body"],
                                smpl_body.SMPL_PARENTS, inputs["mean"],
                                images, stages, cfg["ief_iterations"], bits)
    return run


def flops_per_frame(cfg: dict) -> float:
    return roofline.hmr_smpl_flops(cfg)
