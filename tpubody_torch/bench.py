"""Benchmark: batched HMR + SMPL inference throughput on one GPU.

The port's counterpart of the repository's ``bench.py``: images -> HMR
(ResNet-50 + 3-step IEF, bf16 backbone) -> batched SMPL LBS through the
fused CUDA kernel -> (B, 6890, 3) posed meshes, at batch 512.  Prints ONE
JSON line ``{"metric", "value", "unit", "vs_baseline", "lbs_path",
"batch", "device", "split_ms"}``.  There is no fallback: if the step
fails, the run fails.

    python -m tpubody_torch.bench [--batch 512] [--iters 30]

``--fused-stage {1,2}`` measures instead the fused residual stage
(``models/fused_resnet.py``, the CUDA kernel ``csrc/fused_stage.cu``)
against the library's bf16 convolutions on the same stride-1 bottleneck
chain at the flagship's shapes, and prints its JSON line.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve

BATCH = 512
WARMUP = 3
ITERS = 30
TARGET_FPS = 1000.0   # BASELINE.json's frames/sec target
# The stride-1 bottleneck chains of ResNet-50 at a 224^2 input: (block
# indices, features, height = width, input channels).  Stage 2's block 0
# is stride-2 and stays with the library.
STAGE_SHAPES = {1: ((0, 1, 2), 64, 56, 64), 2: ((1, 2, 3), 128, 28, 512)}
BACKBONE_PARTS = ("stem", "layer1", "layer2", "layer3", "layer4", "pool")


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
def backbone_split(step, images: torch.Tensor, iters: int) -> Dict[str, float]:
    """Device ms per step of the backbone's parts (the stem with its
    max-pool, the four residual stages, the global average pool), from
    CUDA events between them, averaged over ``iters`` steps."""
    bb = step.hmr.backbone
    totals = dict.fromkeys(BACKBONE_PARTS, 0.0)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(BACKBONE_PARTS) + 1)]
        ev[0].record()
        x = bb.stem(images)
        ev[1].record()
        for i in range(4):
            x = getattr(bb, f"layer{i + 1}")(x)
            ev[i + 2].record()
        torch.mean(x, dim=(2, 3))
        ev[6].record()
        torch.cuda.synchronize()
        for i, name in enumerate(BACKBONE_PARTS):
            totals[name] += ev[i].elapsed_time(ev[i + 1])
    return {k: v / iters for k, v in totals.items()}


@torch.no_grad()
def randomize_batchnorm(module: torch.nn.Module, seed: int = 0) -> None:
    """Seeded (numpy) BatchNorm affine parameters and running statistics,
    so that folding them into the convolutions is not trivial: the seeded
    initialisation leaves scale 1, bias 0, mean 0, var 1."""
    rng = np.random.default_rng(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features

            def put(t, a):
                t.copy_(torch.as_tensor(a, dtype=t.dtype))

            put(m.weight, rng.uniform(0.5, 1.5, n))
            put(m.bias, 0.1 * rng.normal(size=n))
            put(m.running_mean, 0.1 * rng.normal(size=n))
            put(m.running_var, rng.uniform(0.5, 1.5, n))


@torch.no_grad()
def build_stage_chain(stage: int = 1, blocks: int = 0, seed: int = 0,
                      shape: Optional[Sequence] = None):
    """The stride-1 bottleneck chain of a ResNet-50 stage from the port's
    ``Bottleneck``, on the CPU in float32, every weight and BatchNorm
    statistic drawn uniformly from [0.02, 0.1] with a seeded numpy
    generator (bounded, non-zero: timing and parity only), and its
    FusedStage.  ``blocks``: fuse only the first N blocks (0 = the whole
    chain); ``shape``: other (block ids, features, size, input channels)
    than the stage's.  -> (chain, fused, (height, width, input channels))."""
    from tpubody_torch.models import fused_resnet
    from tpubody_torch.models.hmr import Bottleneck

    block_ids, feats, hw, c_in = shape or STAGE_SHAPES[stage]
    if blocks:
        block_ids = block_ids[:blocks]
    mods, c = [], c_in
    for _ in block_ids:
        mods.append(Bottleneck(c, feats, 1))
        c = feats * 4
    chain = torch.nn.Sequential(*mods).eval()
    rng = np.random.default_rng(seed)
    for t in chain.state_dict().values():
        if t.dtype.is_floating_point:
            t.copy_(torch.as_tensor(rng.uniform(0.02, 0.1, tuple(t.shape)),
                                    dtype=t.dtype))
    fused = fused_resnet.fuse_stage(chain, list(range(len(block_ids))))
    return chain, fused, (hw, hw, c_in)


def stage_work(fused, batch: int, height: int, width: int) -> Dict[str, float]:
    """Operations and bytes of one run of a fused stage, as the function
    needs them whatever the launch count: two operations a multiply-add of
    the three convolutions and the downsample, the input read once and the
    output written once in bf16, the weights and biases read once."""
    pixels = batch * height * width
    flop_per_pixel, wbytes = 0, 0
    for A1, b1, A2, b2, A3, b3, Ad, bd in fused.blocks():
        for A, b in ((A1, b1), (A2, b2), (A3, b3), (Ad, bd)):
            if A is not None:
                flop_per_pixel += 2 * A.numel()
                wbytes += 2 * A.numel() + 4 * b.numel()
    c_in, c_out = fused.A1_0.shape[1], fused.A3_0.shape[0]
    return {"flop": float(flop_per_pixel) * pixels,
            "flop_per_pixel": flop_per_pixel,
            "bytes": 2.0 * pixels * (c_in + c_out) + wbytes}


def _event_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def fused_stage(stage: int = 1, batch: int = BATCH, iters: int = 20,
                blocks: int = 0, what: str = "both",
                device: DeviceLike = "cuda") -> dict:
    """The fused residual stage against the library's bf16 chain at the
    flagship's shapes (stage 1: blocks 0-2, 64 features, 56^2, 64 input
    channels; stage 2: blocks 1-3, 128 features, 28^2, 512 input channels).
    ``what``: "parity" (relative error max |d| / max |ref| on 2 images
    against the library chain), "fused" (``fused_ms``), "library"
    (``library_ms``), or "both" (all three); times are CUDA-event ms a run
    of the whole chain after warm-up."""
    from tpubody_torch import native
    from tpubody_torch.models import fused_resnet

    if what not in ("both", "fused", "library", "parity"):
        raise ValueError(f"what={what!r}")
    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the GPU; device must be "
                           "CUDA")
    chain, fused, (H, W, c_in) = build_stage_chain(stage, blocks)
    fused = fused.to(dev)
    chain.to(dev)
    for m in chain.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(batch, H, W, c_in)).astype(np.float32),
                        device=dev).to(torch.bfloat16)

    def library(t):           # NHWC permuted to NCHW is channels_last
        return chain(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    res = {"stage": stage, "batch": batch, "blocks": len(chain),
           "shape": [H, W, c_in, int(fused.A3_0.shape[0])],
           "device": torch.cuda.get_device_name(dev),
           **stage_work(fused, batch, H, W)}
    if what in ("both", "parity"):
        ref = library(x[:2]).float()
        got = fused_resnet.run_stage(x[:2], fused).float()
        res["parity_rel_err"] = ((got - ref).abs().max()
                                 / (ref.abs().max() + 1e-9)).item()
    if what in ("both", "fused"):
        before = native.LAUNCHES["fused_stage"]
        fused_resnet.run_stage(x, fused)
        res["launches_per_run"] = native.LAUNCHES["fused_stage"] - before
        res["fused_ms"] = _event_ms(
            lambda: fused_resnet.run_stage(x, fused), iters, 2)
    if what in ("both", "library"):
        res["library_ms"] = _event_ms(lambda: library(x), iters, 2)
    return res


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
        "backbone_split_ms": backbone_split(step, images, max(3, iters // 3)),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused-stage", type=int, choices=(1, 2), default=None,
                    help="measure the fused residual stage instead")
    ap.add_argument("--blocks", type=int, default=0,
                    help="fuse only the first N blocks (0 = whole chain)")
    ap.add_argument("--what", default="both",
                    choices=("both", "fused", "library", "parity"))
    args = ap.parse_args(argv)
    if args.fused_stage:
        print(json.dumps(fused_stage(args.fused_stage, args.batch, args.iters,
                                     args.blocks, args.what, args.device)))
        return
    print(json.dumps(run(args.batch, args.iters, device=args.device)))


if __name__ == "__main__":
    main()
