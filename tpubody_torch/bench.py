"""Benchmark: batched HMR + SMPL inference throughput on one GPU.

The port's counterpart of the repository's ``bench.py``: images -> HMR
(ResNet-50 + 3-step IEF, bf16 backbone) -> batched SMPL LBS through the
fused CUDA kernel -> (B, 6890, 3) posed meshes, at batch 512.  Prints ONE
JSON line ``{"metric", "value", "unit", "vs_baseline", "lbs_path",
"batch", "device", "split_ms"}``.  There is no fallback: if the step
fails, the run fails.

    python -m tpubody_torch.bench [--batch 512] [--iters 30]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve

BATCH = 512
WARMUP = 3
ITERS = 30
TARGET_FPS = 1000.0   # BASELINE.json's frames/sec target


def make_step(device: DeviceLike = "cuda"):
    """The flagship step with the bench's body (the synthetic blob at
    6890 vertices, as the JAX bench uses)."""
    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import params as params_lib
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    dev = resolve(device)
    model = hmr_lib.create_hmr(dtype=torch.bfloat16, device=dev)
    body = params_lib.synthetic(n_joints=24, n_verts=6890, seed=0,
                                device=dev)
    return HMRSMPLStep(model, body, dev, image_size=224)


@torch.inference_mode()
def layer_split(step, images: torch.Tensor, iters: int) -> Dict[str, float]:
    """Device ms per step of each layer (backbone, IEF head, LBS prologue,
    fused_lbs), from CUDA events between the layers, averaged."""
    from tpubody_torch.core import fused_lbs

    names = ("backbone", "ief_head", "lbs_prologue", "fused_lbs")
    totals = dict.fromkeys(names, 0.0)
    layouts = fused_lbs.model_layouts(step.body)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xf = step.hmr.backbone(images)
        ev[1].record()
        out = step.hmr.ief(xf)
        ev[2].record()
        feat, g = fused_lbs.lbs_prologue(layouts, step.body.parents,
                                         out.rotmats, out.shape,
                                         pose_is_rotmat=True)
        ev[3].record()
        fused_lbs.fused_lbs(layouts.basis, layouts.wT, feat, g, None,
                            "bf16x3")        # forward_batch_verts' default
        ev[4].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: v / iters for k, v in totals.items()}


@torch.inference_mode()
def run(batch: int = BATCH, iters: int = ITERS, warmup: int = WARMUP,
        device: DeviceLike = "cuda") -> dict:
    """Time the flagship step at ``batch`` with CUDA events after warm-up."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the GPU; device must be "
                           "CUDA")
    step = make_step(dev)
    rng = np.random.default_rng(0)
    images = torch.as_tensor(
        rng.normal(size=(batch, 224, 224, 3)).astype(np.float32), device=dev)
    for _ in range(warmup):
        step(images)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        verts, cam = step(images)
    end.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(end) / iters
    if not (torch.isfinite(verts).all() and torch.isfinite(cam).all()):
        raise RuntimeError("non-finite output from the flagship step")
    fps = batch * 1e3 / ms
    return {
        "metric": "hmr_smpl_inference_throughput",
        "value": fps,
        "unit": "frames/sec/chip",
        "vs_baseline": fps / TARGET_FPS,
        "lbs_path": "cuda-fused_lbs",
        "batch": batch,
        "step_ms": ms,
        "device": torch.cuda.get_device_name(dev),
        "split_ms": layer_split(step, images, max(3, iters // 3)),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.batch, args.iters, device=args.device)))


if __name__ == "__main__":
    main()
