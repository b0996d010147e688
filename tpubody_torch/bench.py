"""Timings of two paths on one GPU: the fused residual stage and fitting.
The serving step's throughput is the repository's benchmark
(``python3 -m benchmark.run``).

``--fit N [--sequence --block B]`` measures the fitting path
(the counterpart of ``tools/bench_fit.py``): N frames of seeded poses
through ``fit.smplify.fit_frames`` at ``FitConfig()`` defaults on the
6890-vertex, 52-joint seeded SMPLH with 12 PCA hand components, first
call and warm, or a T=N frame clip through chained ``fit_sequence`` at
block B, and prints its JSON line (ms/frame, mean final loss, the split
between the camera stage and the body stages, objective evaluations,
line-search steps and device-to-host reads).

``--fused-stage {1,2,3,4} [--batch 512] [--iters 30]`` measures the
fused residual stage (``models/fused_resnet.py``, the CUDA kernel
``csrc/fused_stage.cu``) against the library's bf16 convolutions on the
same stride-1 bottleneck chain at the flagship's shapes, and prints its
JSON line.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve

BATCH = 512
ITERS = 30
# The stride-1 bottleneck chains of ResNet-50 at a 224^2 input: (block
# indices, features, height = width, input channels).  Stage 2's block 0
# is stride-2 and stays with the library.
# ResNet-50's stride-1 chains: (block ids, features, size, input channels)
STAGE_SHAPES = {1: ((0, 1, 2), 64, 56, 64), 2: ((1, 2, 3), 128, 28, 512),
                3: ((1, 2, 3, 4, 5), 256, 14, 1024),
                4: ((1, 2), 512, 7, 2048)}


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
    channels; stage 2: blocks 1-3, 128 features, 28^2, 512 input channels;
    stage 3: blocks 1-5, 256 features, 14^2, 1024; stage 4: blocks 1-2, 512
    features, 7^2, 2048).
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


# -- the fitting path -------------------------------------------------------
FIT_FOCAL = 5000.0
FIT_SIZE = 1024           # image side: the principal point is its center
FIT_NOISE_PX = 2.0


def fit_model(n_verts: int = 6890, seed: int = 0,
              device: DeviceLike = "cuda"):
    """The fit path's body: the seeded SMPLH stand-in (52 joints) with
    seeded hand PCA bases (45 components a hand, the fit uses the first
    ``FitConfig.num_pca_comps``) and hand means."""
    import dataclasses

    from tpubody_torch.models import params as params_lib

    dev = resolve(device)
    model = params_lib.load_or_synthetic("smplh", n_joints=52,
                                         n_verts=n_verts, seed=seed,
                                         warn=False, device=dev)
    rng = np.random.default_rng(seed + 1000)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return dataclasses.replace(
        model, cache={},
        hands_components_l=t(rng.normal(scale=0.1, size=(45, 45))),
        hands_components_r=t(rng.normal(scale=0.1, size=(45, 45))),
        hands_mean_l=t(rng.normal(scale=0.1, size=45)),
        hands_mean_r=t(rng.normal(scale=0.1, size=45)))


def fit_truth(model, decoder, n: int, seed: int) -> Dict[str, np.ndarray]:
    """Seeded ground truth for n frames: VPoser-decoded body poses, a global
    orientation near zero (the fit's start, as in tpubody's fit tests),
    PCA hand poses, betas and a camera ~12 m away."""
    from tpubody_torch.fit import vposer as vposer_lib

    dev = model.device
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(rng.normal(scale=0.5, size=(n, 32)),
                        dtype=torch.float32, device=dev)
    with torch.no_grad():
        body = vposer_lib.decode_to_axis_angle(decoder, z).cpu().numpy()
    orient = rng.normal(scale=0.15, size=(n, 3))
    hands = []
    for comps, mean in ((model.hands_components_l, model.hands_mean_l),
                        (model.hands_components_r, model.hands_mean_r)):
        coeffs = rng.normal(scale=0.5, size=(n, 12))
        hands.append(mean.cpu().numpy() + coeffs @ comps[:12].cpu().numpy())
    cam_t = np.stack([rng.normal(scale=0.05, size=n),
                      rng.normal(scale=0.05, size=n),
                      12.0 + rng.uniform(-1.0, 1.0, size=n)], axis=1)
    return {"pose": np.concatenate([orient, body] + hands, axis=1),
            "betas": rng.normal(scale=0.5, size=(n, 10)),
            "cam_t": cam_t}


def project_fit(model, pose, betas, cam_t) -> np.ndarray:
    """(n, 67, 2) OpenPose joints of full-model forwards, projected at
    ``FIT_FOCAL`` about the image center."""
    from tpubody_torch.fit import joints as joints_lib
    from tpubody_torch.fit import smplify
    from tpubody_torch.models import smpl as smpl_lib

    dev = model.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    n = len(pose)
    with torch.no_grad():
        st = smpl_lib.forward(model, t(pose).reshape(n, -1, 3), t(betas))
        j = joints_lib.openpose_joints(st.verts, st.joints_posed)
        center = torch.full((n, 2), FIT_SIZE / 2.0, device=dev)
        return smplify._project(j, t(cam_t), FIT_FOCAL,
                                center).cpu().numpy()


def fit_keypoints(target2d: np.ndarray, seed: int) -> np.ndarray:
    """Detections: the projected joints plus ``FIT_NOISE_PX`` noise, with
    confidence 1 -> (n, 67, 3) float32."""
    rng = np.random.default_rng(seed)
    noisy = target2d + rng.normal(scale=FIT_NOISE_PX, size=target2d.shape)
    return np.concatenate([noisy, np.ones(target2d.shape[:-1] + (1,))],
                          axis=-1).astype(np.float32)


def fit_clip(model, decoder, T: int, seed: int) -> np.ndarray:
    """A smooth T-frame keypoint clip: one seeded pose whose body drifts
    and turns a little from frame to frame."""
    truth = fit_truth(model, decoder, 1, seed)
    rng = np.random.default_rng(seed + 1)
    steps = np.cumsum(rng.normal(scale=0.02, size=(T, 3)), axis=0)
    pose = np.repeat(truth["pose"], T, axis=0)
    pose[:, :3] += steps
    cam_t = np.repeat(truth["cam_t"], T, axis=0)
    cam_t[:, :2] += np.cumsum(rng.normal(scale=0.01, size=(T, 2)), axis=0)
    target = project_fit(model, pose, np.repeat(truth["betas"], T, axis=0),
                         cam_t)
    return fit_keypoints(target, seed + 2)


def _fit_stats(fitter) -> dict:
    out = {}
    for part, st in fitter.stats.items():
        it = max(st.get("iterations", 0), 1)
        out[part] = dict(st, evaluations_per_iteration=st.get(
            "evaluations", 0) / it)
    return out


def fit(n: int = 64, sequence: bool = False, block: int = 1,
        n_verts: int = 6890, device: DeviceLike = "cuda",
        model=None, decoder=None) -> dict:
    """Time the fitting path on the card: ``fit_frames`` on n frames (a
    first call, then a warm call on other frames), or chained
    ``fit_sequence`` on an n-frame clip at ``block``."""
    from tpubody_torch.fit import smplify
    from tpubody_torch.fit import vposer as vposer_lib

    dev = resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the GPU; device must be "
                           "CUDA")
    model = model if model is not None else fit_model(n_verts, device=dev)
    decoder = decoder if decoder is not None else \
        vposer_lib.create_decoder(0, device=dev)
    cfg = smplify.FitConfig()
    center = np.array([FIT_SIZE / 2.0, FIT_SIZE / 2.0], np.float32)
    res = {"mode": "sequence" if sequence else "frames", "verts": n_verts,
           "stages": len(cfg.body_pose_prior_weights),
           "maxiters": cfg.maxiters, "device": torch.cuda.get_device_name(dev)}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    if sequence:
        kps = fit_clip(model, decoder, n, seed=5)
        out, ms = timed(lambda: smplify.fit_sequence(
            model, kps, center, cfg, dec_params=decoder, block=block,
            device=dev))
        res.update(T=n, block=block, ms_per_frame=ms / n,
                   mean_loss=float(np.mean(out.loss)),
                   losses_finite=bool(np.isfinite(out.loss).all()))
        return res
    for label, seed in (("first", 1), ("warm", 2)):
        kps = fit_keypoints(project_fit(model, **fit_truth(
            model, decoder, n, seed)), seed)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fitter = smplify.BatchFitter(model, cfg, dec_params=decoder,
                                     device=dev)
        setup_ms = 1e3 * (time.perf_counter() - t0)
        out = fitter(kps, center)
        ms = 1e3 * (time.perf_counter() - t0)
        res[f"{label}_ms_per_frame"] = ms / n
        res[f"{label}_setup_ms"] = setup_ms
    cam_ms, stages_ms = fitter.split_ms()
    res.update(N=n, mean_loss=float(np.mean(out.loss)),
               losses_finite=bool(np.isfinite(out.loss).all()),
               camera_ms=cam_ms, stages_ms=stages_ms,
               counts=_fit_stats(fitter))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fused-stage", type=int, choices=tuple(STAGE_SHAPES),
                    default=None,
                    help="measure the fused residual stage")
    ap.add_argument("--blocks", type=int, default=0,
                    help="fuse only the first N blocks (0 = whole chain)")
    ap.add_argument("--what", default="both",
                    choices=("both", "fused", "library", "parity"))
    ap.add_argument("--fit", type=int, default=None, metavar="N",
                    help="measure the fitting path on N frames")
    ap.add_argument("--sequence", action="store_true",
                    help="with --fit: a chained fit_sequence of N frames")
    ap.add_argument("--block", type=int, default=1,
                    help="with --fit --sequence: frames a chained block")
    args = ap.parse_args(argv)
    if args.fit:
        print(json.dumps(fit(args.fit, args.sequence, args.block,
                             device=args.device)))
        return
    if not args.fused_stage:
        ap.error("give --fused-stage or --fit")
    print(json.dumps(fused_stage(args.fused_stage, args.batch, args.iters,
                                 args.blocks, args.what, args.device)))


if __name__ == "__main__":
    main()
