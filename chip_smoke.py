#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpubody_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

  1. build   — compile the CUDA kernels from tpubody_torch/csrc with nvcc
               for sm_90a (first use builds; the time is printed);
  2. kernels — hold the fused LBS kernel to its plain PyTorch version on
               the card, TF32 off: full width (512 frames, the 6890-vertex
               humanoid) and a ragged shape (5 frames, 700 vertices),
               shared and per-frame betas, axis-angle and rotation-matrix
               poses, both precisions (max |d| < 2e-5 for "highest",
               relative error < 1e-4 for "bf16x3", the bars of
               tests/test_pallas_lbs.py);
  3. serve   — the main path through its entry points at full width:
               hmr_smpl_step (ResNet-50, 224^2, bf16 backbone, 6890-vertex
               body) behind InferenceServer(buckets=(1, 4, 16, 64)), 24
               concurrent requests, each checked against the step applied
               directly to its image (in the batch the server formed, and
               alone); the launch counters are zeroed just before and read
               just after, and every kernel of the path must have
               launched; the fp32 step on the card is also held to the
               same step on the CPU;
  4. bench   — tpubody_torch.bench's flagship step at batch 512: frames/s
               and the per-layer split, from CUDA events after warm-up;
  5. timing  — fused_lbs against its plain version, one PyTorch call
               computing the same contractions, and its bound;
  6. raster  — hold the fused raster kernel to its plain PyTorch version
               on tables that _bin_fused builds: two frames of the video
               clip at full width (1024^2, the humanoid avatar; the base
               pass and each ladder rung; 3 and 6 channels), two random
               64x128 scenes, a 24-channel attribute stack, and a scene
               whose chunk budget overflows.  Gate: win equal at every
               pixel, attributes within 1e-6 of the largest attribute;
  7. video   — the animation path at full width through its entry point:
               a humanoid avatar (6890 vertices, 13,524 faces) saved with
               save_avatar, a seeded 64-frame AMASS-format clip, then
               animate_from_amass(..., stride=1, size=1024) with the
               defaults.  The launch counters are zeroed just before and
               fused_raster must have launched (blocks x passes) times.
               The frames handed to the writer are collected and checked
               (64 frames of 1024x1024, body inside the projected bbox,
               consecutive frames different).  Where cv2 is missing the
               encoder, and only the encoder, is replaced by a frame
               collector.  Run once more for 8 frames with
               i420_transfer=False, crop_transfer=False;
  8. oracle  — two frames through render_frames_tiled and through the
               fragment renderer render_frames at 256^2: more than 99.5%
               of values within 2e-2;
  9. video timing — frames/s of a warm second pass of the video path and
               CUDA-event times per layer; fused_raster against its plain
               version and its bound.

  10. zbuffer — hold the z-buffer kernel to its plain PyTorch version on
               tables that bin_faces builds: the body-map scene at full
               width (the fitted 6890-vertex SMPLH body at 1024^2, focal
               5000; front, back and all faces), two random 64x128 scenes
               of two frames, a scene under 64 faces (the wrapped key) and
               one whose tiles overflow.  Gate: equal at every pixel.  On
               the body-map scene its face ids are also held to the fused
               raster kernel's (at least 99.9% of the pixels);
  11. reconstruct — the device half of the reconstruct pipeline at full
               width: the in-memory demo fixture (humanoid(52, 6890) and
               humanoid(24, 6890), the demo pose and betas, focal 5000 at
               1024^2; the photo mask rendered at other betas, so the warp
               moves pixels), through the helper of
               tpubody_torch.pipelines.reconstruct with the cache off, and
               the front normal map once more through rasterize_tiled.  The
               launch counters are zeroed just before and read just after:
               fused_raster 3 launches, zbuffer 1.  Gates: background 1.0
               and weights summing to 1 in the value map, the warped map
               filling the photo mask, PCG's relative residual under 1e-3,
               finite depths that are zero outside the mask, the
               rasterize_tiled map equal to the fused one's within 2e-3 on
               99.9% of the pixels.  The same path at 256^2 on the card
               and on the CPU, within the tests' tolerances, and through
               the public reconstruct(), which must raise at the stitch;
  12. rtiming — CUDA-event spans of the stages and the warp's substages in
               a second run of the helper, the card's busy share of
               normal2depth and of the warp under torch.profiler, the
               z-buffer kernel alone against its plain version and its
               bound, and fused_raster at 24 channels.

  13. stage   — hold the fused residual-stage kernel to its plain PyTorch
               version on the card, TF32 off: the four small shapes of
               tests/test_pallas_resnet.py (3 blocks with a downsample at
               12x12, 2 identity blocks at 8x8, a single block at 10x10, 2
               blocks at 11x19, all with 4 features), a zero input, and
               full width at batch 8 (stage 1: 56^2, 64 -> 256 channels, 3
               blocks; stage 2 tail: 28^2, 512 channels, 3 blocks) with
               seeded weights and BatchNorm statistics.  Gate, on every
               block alone and on the small chains: max |d| within 2 bf16
               ulps of the largest output (2^-7 of it) and at least 99% of
               the elements equal bit for bit: both round h1, h2 and y to
               bf16 at the same places and differ only in the order of
               their f32 sums.  A full-width chain of three: 4 ulps;
  14. backbone — the fused stage on the full-width serving model:
               create_hmr(dtype=bf16) (ResNet-50 at (3, 4, 6, 3)) with
               seeded BatchNorm statistics, 512 images of 224^2 through the
               model's own stem, then fuse_stage(layer1, [0, 1, 2]) ->
               run_stage against layer1 by the library's bf16
               convolutions, layer2[0] by the library, and
               fuse_stage(layer2, [1, 2, 3]) -> run_stage against
               layer2[1:]: max |d| / max |ref| < 2e-2 (the bar of
               tests/test_pallas_resnet.py).  The launch counters are
               zeroed just before and fused_stage must have launched 6
               times.  The same two outputs are then held to the plain
               version on the same inputs and weights, all 512 images in
               chunks of 8 (the gates of phase 13, block by block on the
               first chunk), which also times the plain version at that
               batch.  Then tpubody_torch.bench.fused_stage(1) and (2)
               (kernel and library ms at batch 512), the bound,
               bench.backbone_split of the flagship
               step, and the s2d stem against conv7 (fp32 within 1e-4, and
               both stems' ms in bf16).

It then prints the kernel line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  It needs one CUDA GPU and no network.
``--phases a,b`` runs a subset (names: lbs, serve, bench, raster, video,
oracle, vtiming, zbuffer, reconstruct, rtiming, stage, backbone, and the
extra vprofile: a
torch.profiler pass over the video path) and prints no result line: a
development aid.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM data-sheet peaks (the table of the repository's measurement
# notes): HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16
# tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

SAME_BATCH_ATOL = 1e-5    # served vs the same batch applied directly
BATCH1_VERT_ATOL = 0.1    # m; bf16 at batch 1 vs in a bucket (see below)
CPU_HMR_ATOL = 1e-4       # fp32 HMR outputs, card vs CPU
CPU_VERT_ATOL = 1e-4      # LBS, card vs CPU: the repo's vertex budget
RASTER_ATTR_REL = 1e-6    # fused_raster attrs vs plain, of the largest attr
ORACLE_ATOL = 2e-2        # tiled vs fragment renderer, per value
ORACLE_AGREE = 0.995      # share of values that must agree
# fused_raster, operations per face and pixel, counted from the kernel's
# source: three edge functions of one multiply and two adds each (9), the
# three a*px products shared by a thread's four pixels (0.75), three
# comparisons (3); depth and key only where a pixel is covered (not
# counted).
RASTER_OPS_PER_FACE_PIXEL = 12.75
VIDEO_FRAMES = 64
VIDEO_SIZE = 1024
RECON_SIZE = 1024
RECON_SMALL = 256         # the card-vs-CPU run of the reconstruct path
FACE_ID_AGREE = 0.999     # zbuffer vs fused_raster face ids, share of pixels
TILED_MAP_ATOL = 2e-3     # rasterize_tiled (exact barycentrics) vs fused
TILED_MAP_AGREE = 0.999
PCG_RELRES = 1e-3
# The 24 rendered weights sum to 1 inside the body: within 1e-4 at 1024^2.
# At 256^2 every face of the 6890-vertex body is smaller than a pixel, the
# affine planes' slopes (~ 1 / area) are large, and their float32 rounding
# reaches the sum: 1e-3 there.
WSUM_ATOL = 1e-4
WSUM_ATOL_SMALL = 1e-3
DEPTH_REL = 1e-3          # card vs CPU depth, of the depth range
WEIGHT_ATOL = 1e-3        # card vs CPU stitch weights (they cross as f16)
CHAIN_MEAN_REL = 1e-2     # free-running chain: mean depth difference
TIGHT_SHARE = 0.999       # share of pixels held to the tight bars
# The demo fixture of the reconstruct pipeline: body shape (girth +2.5
# keeps the forearms several pixels wide) and the shape of the "photo".
BACKBONE_BATCH = 512
# fused_stage vs its plain version.  Both round h1, h2 and y to bf16 at the
# same places and differ in the order of their f32 sums, so an element can
# land on the other side of a rounding boundary.  One block on the same
# input bits: within 2 bf16 ulps of the largest output, 99% of the elements
# equal bit for bit (measured: 1 ulp; 99.58% to 99.98% at full width, 100%
# at 4 features).  That is the gate that binds, and it is applied to every
# block of every case, at full width too.  A chain compounds the
# difference: a 1-ulp change of one input moves C_mid sums of h1, each of
# which feeds 9 * C_mid sums of h2, so after three blocks at full width
# 97.3% (stage 1) and 85.1% (stage 2's tail) of the elements were equal, 2
# ulps apart at most, where two evaluations of the plain version itself
# (the card's convolutions and the CPU's) agreed on 99.4% and 98.3%.  The
# share of equal elements of a full-width chain depends on the weights and
# says nothing a block's does not, so it is printed and not gated: a
# full-width chain is held to 4 ulps, the small chains (as every single
# block) to 2 ulps and 99%.
STAGE_EQUAL = 0.99        # share of elements equal bit for bit
STAGE_CHAIN_ULPS = 4      # full-width chain of three blocks
STAGE_CHUNK = 8           # images a call of the plain version at batch 512
STAGE_LIB_REL = 2e-2      # fused_stage vs the library's bf16 chain
STEM_ATOL = 1e-4          # s2d vs conv7 stem, fp32 HMR outputs
DEMO_BETAS = np.array([0.0, 2.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)
PHOTO_BETAS = np.array([0.6, 1.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

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


def lbs_inputs(body, F, rng, rotmat, per_frame_beta, with_trans):
    import torch

    from tpubody_torch.core import fused_lbs, rotations

    dev = body.device
    aa = torch.as_tensor(rng.normal(scale=0.3, size=(F, body.num_joints, 3)),
                         dtype=torch.float32, device=dev)
    poses = rotations.rodrigues(aa) if rotmat else aa
    shape = (F, body.num_betas) if per_frame_beta else (body.num_betas,)
    beta = torch.as_tensor(rng.normal(scale=0.5, size=shape),
                           dtype=torch.float32, device=dev)
    trans = (torch.as_tensor(rng.normal(size=(F, 3)), dtype=torch.float32,
                             device=dev) if with_trans else None)
    layouts = fused_lbs.model_layouts(body)
    feat, g = fused_lbs.lbs_prologue(layouts, body.parents, poses, beta,
                                     pose_is_rotmat=rotmat)
    return layouts, feat, g, trans, (poses, beta)


def phase_kernels(dev):
    import torch

    from tpubody_torch.core import fused_lbs
    from tpubody_torch.models import humanoid, params, smpl

    rng = np.random.default_rng(0)
    full = humanoid.humanoid(n_joints=24, n_verts=6890, device=dev)
    ragged = params.synthetic(n_joints=24, n_verts=700, seed=2, device=dev)
    cases = [
        ("full aa shared-beta trans", full, 512, False, False, True),
        ("full rotmat per-frame-beta", full, 512, True, True, False),
        ("ragged aa shared-beta trans", ragged, 5, False, False, True),
        ("ragged rotmat per-frame-beta trans", ragged, 5, True, True, True),
    ]
    main_err = None
    for name, body, F, rotmat, pfb, tr in cases:
        layouts, feat, g, trans, (poses, beta) = lbs_inputs(
            body, F, rng, rotmat, pfb, tr)
        for prec in fused_lbs.PRECISIONS:
            got = fused_lbs.fused_lbs(layouts.basis, layouts.wT, feat, g,
                                      trans, prec)
            torch.cuda.synchronize()
            ref = fused_lbs.fused_lbs_reference(layouts.basis, layouts.wT,
                                                feat, g, trans, prec)
            if got.shape != (F, body.num_verts, 3):
                raise RuntimeError(f"{name}: shape {tuple(got.shape)}")
            err = (got - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ok = err < 2e-5 if prec == "highest" else rel < 1e-4
            log(f"  {name:36s} {prec:8s} max|d|={err:.3e} rel={rel:.3e}"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"fused_lbs disagrees with its plain "
                                   f"version: {name} {prec}")
            if prec == "highest":
                lbs = smpl.forward_batch(body, poses, beta, trans,
                                         pose_is_rotmat=rotmat).verts
                err_lbs = (got - lbs).abs().max().item()
                if err_lbs >= 2e-5:
                    raise RuntimeError(f"fused_lbs vs torch-op LBS {name}: "
                                       f"{err_lbs}")
            if name.startswith("full rotmat") and prec == "bf16x3":
                main_err = err
    return full, main_err


def phase_serve(dev):
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import smpl
    from tpubody_torch.pipelines import serving

    rng = np.random.default_rng(1)
    images = rng.normal(size=(24, 224, 224, 3)).astype(np.float32)
    step = serving.hmr_smpl_step(device=dev)
    batches = []          # (batch images, outputs) of every dispatched batch

    def recording_step(batch):
        out = step(batch)
        batches.append((batch.clone(), out))
        return out

    native.reset_launches()
    server = serving.InferenceServer(recording_step, step.image_shape,
                                     buckets=(1, 4, 16, 64), device=dev)
    batches.clear()       # drop the warm-up batches
    futures = [None] * len(images)

    def send(i):
        futures[i] = server.submit(images[i])

    t0 = time.perf_counter()
    with server:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=300) for f in futures]
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    snap = server.stats.snapshot()
    log(f"  served {snap['requests']} requests in {snap['batches']} batches"
        f" of sizes {[len(b) for b, _ in batches]} ({wall:.3f} s):"
        f" p50 {snap['latency_p50_ms']:.3f} ms,"
        f" p99 {snap['latency_p99_ms']:.3f} ms; launches {launches}")
    if launches["fused_lbs"] == 0:
        raise RuntimeError("fused_lbs was not launched on the serving path")

    # Each future against the step applied directly to its image, in the
    # bucket batch the server formed for it: same inputs and shapes, so
    # the same result up to SAME_BATCH_ATOL.  The step at batch 1 is also
    # compared, at the looser BATCH1_VERT_ATOL: cuDNN may choose other
    # bf16 algorithms per batch size, and at the stand-in mean parameters
    # (tpubody's default_mean_params) the second 6D column is near zero,
    # so bf16 noise turns the Gram-Schmidt frame measurably.
    direct = [step(b) for b, _ in batches]
    worst = worst_1 = 0.0
    for img, (verts, cam) in zip(images, results):
        if verts.shape != (6890, 3) or cam.shape != (3,):
            raise RuntimeError(f"bad shapes {verts.shape} {cam.shape}")
        if not (np.isfinite(verts).all() and np.isfinite(cam).all()):
            raise RuntimeError("non-finite served output")
        x = torch.as_tensor(img, device=dev)
        hits = [(k, r) for k, (b, _) in enumerate(batches)
                for r in range(len(b)) if torch.equal(b[r], x)]
        if not hits:
            raise RuntimeError("a request's image is in no dispatched batch")
        k, r = hits[0]
        v_d, c_d = direct[k][0][r].cpu().numpy(), direct[k][1][r].cpu().numpy()
        worst = max(worst, float(np.abs(verts - v_d).max()),
                    float(np.abs(cam - c_d).max()))
        v_1, _ = step(img[None])
        worst_1 = max(worst_1, float(np.abs(verts - v_1[0].cpu().numpy()).max()))
    log(f"  served vs direct (same batch): max|d|={worst:.3e};"
        f" vs direct at batch 1: verts max|d|={worst_1:.3e} m")
    if worst > SAME_BATCH_ATOL or worst_1 > BATCH1_VERT_ATOL:
        raise RuntimeError("served results differ from the direct step")

    # Reference on a small input: the fp32 step on the card against the
    # same step on the CPU, in its two well-conditioned parts: the HMR
    # outputs (cuDNN, TF32 off, vs CPU convolutions), and the LBS on the
    # same rotations and shapes (the fused kernel vs the CPU torch-op LBS).
    step32 = serving.hmr_smpl_step(dtype=torch.float32, device=dev)
    step_cpu = serving.hmr_smpl_step(dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        out_gpu = step32.hmr(torch.as_tensor(images[:2], device=dev))
        out_cpu = step_cpu.hmr(torch.as_tensor(images[:2]))
        err_hmr = max((a.cpu() - b).abs().max().item() for a, b in
                      zip(out_gpu, out_cpu))
        v_gpu = smpl.forward_batch_verts(
            step32.body, out_cpu.rotmats.to(dev), out_cpu.shape.to(dev),
            pose_is_rotmat=True)
        v_cpu = smpl.forward_batch_verts(
            step_cpu.body, out_cpu.rotmats, out_cpu.shape,
            pose_is_rotmat=True)
    err_lbs = (v_gpu.cpu() - v_cpu).abs().max().item()
    log(f"  fp32 card vs CPU: HMR outputs max|d|={err_hmr:.3e},"
        f" verts on the same inputs max|d|={err_lbs:.3e}")
    if err_hmr > CPU_HMR_ATOL or err_lbs > CPU_VERT_ATOL:
        raise RuntimeError("the card disagrees with the CPU reference")
    return launches, snap


def phase_bench(dev):
    from tpubody_torch import bench

    res = bench.run(batch=512, iters=20, device=dev)
    log(f"  bench: {res['value']:.1f} frames/s at batch 512"
        f" ({res['step_ms']:.3f} ms/step); split ms {res['split_ms']};"
        f" backbone split ms {res['backbone_split_ms']}")
    log(json.dumps(res))
    return res


def phase_timing(body, launches, main_err):
    import torch

    from tpubody_torch.core import fused_lbs

    rng = np.random.default_rng(3)
    layouts, feat, g, trans, _ = lbs_inputs(body, 512, rng, True, True, False)
    F, K = feat.shape
    J, V = layouts.wT.shape
    g2 = g.permute(0, 2, 1).reshape(F * 12, J).contiguous()
    per = {}
    for prec in fused_lbs.PRECISIONS:
        per[prec] = dict(
            ms=time_ms(lambda: fused_lbs.fused_lbs(
                layouts.basis, layouts.wT, feat, g, None, prec)),
            plain_ms=time_ms(lambda: fused_lbs.fused_lbs_reference(
                layouts.basis, layouts.wT, feat, g, None, prec)))
    library_ms = time_ms(lambda: (torch.matmul(feat, layouts.basis),
                                  torch.matmul(g2, layouts.wT)))
    # The least time for this work: each input read once and the output
    # written once, against the operations (contractions: 2*3*K and 2*12*J
    # per frame-vertex; apply + trans: 24) at the peak rate of their type.
    nbytes = 4 * (layouts.basis.numel() + layouts.wT.numel() + feat.numel()
                  + g.numel() + F * V * 3)
    contract = 2.0 * F * V * (3 * K + 12 * J)
    apply_ops = 24.0 * F * V
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bounds = {
        # fp32 FMAs: the CUDA cores' fp32 rate (TF32 is not fp32-exact).
        "highest": (contract + apply_ops) / PEAK_FP32 * 1e3,
        # three bf16 x bf16 products per term: the bf16 tensor-core rate.
        "bf16x3": 3 * contract / PEAK_BF16 * 1e3 + apply_ops / PEAK_FP32 * 1e3,
    }
    main = "bf16x3"
    bound_ms = max(bytes_ms, bounds[main])
    entry = {
        "name": "fused_lbs",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_lbs.cu",
        "replaces": "tpubody/core/pallas_lbs.py:63",
        "replaces_fn": "tpubody/core/pallas_lbs.py::_fused_kernel",
        "precision": main,
        "shape": {"F": F, "V": V, "J": J, "K": K},
        "launches": launches["fused_lbs"],
        "max_abs_err": main_err,
        "max_err": main_err,
        "ms": per[main]["ms"],
        "kernel_ms": per[main]["ms"],
        "plain_ms": per[main]["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= bounds[main] else "operations",
        "library_ms": library_ms,
        "highest": {
            "ms": per["highest"]["ms"],
            "plain_ms": per["highest"]["plain_ms"],
            "bound_ms": max(bytes_ms, bounds["highest"]),
            "bound_by": ("bytes" if bytes_ms >= bounds["highest"]
                         else "operations"),
        },
    }
    return entry


# -- the animation/video path ------------------------------------------------
def random_scene(H, W, n_faces, max_extent, seed, n_chan):
    """Random triangles with bounded projected extent, some offscreen (the
    scene generator of tests/test_pallas_raster.py)."""
    rng = np.random.default_rng(seed)
    V = n_faces
    verts = np.stack([rng.uniform(-20, W + 20, V), rng.uniform(-20, H + 20, V),
                      rng.uniform(1.0, 5.0, V)], 1).astype(np.float32)
    faces = rng.integers(0, V, (n_faces, 3)).astype(np.int32)
    tri = verts[faces]
    cent = tri.mean(1, keepdims=True)
    scale = np.minimum(
        1.0, max_extent / (np.abs(tri[..., :2] - cent[..., :2])
                           .max((1, 2), keepdims=True) * 2 + 1e-6))
    tri = cent + (tri - cent) * scale
    verts2 = tri.reshape(-1, 3).astype(np.float32)
    faces2 = np.arange(n_faces * 3).reshape(n_faces, 3).astype(np.int32)
    attrs = rng.uniform(size=(verts2.shape[0], n_chan)).astype(np.float32)
    return verts2, faces2, attrs


def make_avatar_and_clip(workdir):
    """The humanoid avatar at SMPL's size, saved in the avatar pickle
    schema, and a seeded 64-frame clip in AMASS format -> (avatar,
    avatar_path, clip_path)."""
    from tpubody_torch.mesh import rigging
    from tpubody_torch.models import humanoid

    raw = humanoid.humanoid_numpy(n_joints=24, n_verts=6890)
    rng = np.random.default_rng(5)
    V = raw["v_template"].shape[0]
    avatar = rigging.avatar_from_numpy(
        raw["v_template"], raw["weights"],
        rng.uniform(0.3, 0.9, size=(V, 3)), raw["faces"],
        raw["j_regressor"] @ raw["v_template"], raw["parents"])
    avatar_path = os.path.join(workdir, "avatar.pkl")
    rigging.save_avatar(avatar_path, avatar)

    # Smooth joint angles of about 0.3 rad and a small root translation.
    t = np.arange(VIDEO_FRAMES)[:, None] / VIDEO_FRAMES
    amp = rng.uniform(-0.3, 0.3, size=(1, 66))
    freq = rng.integers(1, 3, size=(1, 66))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 66))
    poses = np.zeros((VIDEO_FRAMES, 156))
    poses[:, :66] = amp * np.sin(2 * np.pi * freq * t + phase)
    trans = 0.05 * np.sin(2 * np.pi * t + rng.uniform(0, 6, size=(1, 3)))
    clip_path = os.path.join(workdir, "clip.npz")
    np.savez(clip_path, poses=poses, trans=trans, mocap_framerate=30.0)
    return avatar, avatar_path, clip_path


class VideoSetup:
    """The video path's inputs on the card: avatar, clip, render plan and
    the skinned frames."""

    def __init__(self, dev, workdir):
        import torch

        from tpubody_torch.io import motion
        from tpubody_torch.mesh import rigging
        from tpubody_torch.render import video

        self.dev = dev
        self.avatar, self.avatar_path, self.clip_path = \
            make_avatar_and_clip(workdir)
        self.clip = motion.read_amass(self.clip_path)
        self.cam_t = np.array([0.0, 0.0, 2.5])
        self.plan = video.plan_tiled_render(
            self.avatar.v_template, self.avatar.faces, self.cam_t,
            VIDEO_SIZE, VIDEO_SIZE, video.DEFAULT_FOCAL)

        def on(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype), device=dev)

        self.faces = on(self.avatar.faces, np.int32)
        self.colors = on(self.avatar.color, np.float32)
        self.cam = on(self.cam_t, np.float32)
        # (faces, span_x, span_y, total_chunks) of the base pass and rungs
        self.passes = [(on(self.plan["small_faces"], np.int32),
                        self.plan["span_x"], self.plan["span_y"],
                        self.plan["total_chunks"])]
        for lf, spec in zip(self.plan["ladder_faces"],
                            self.plan["ladder_specs"]):
            self.passes.append((on(lf, np.int32), spec[0], spec[1], spec[3]))
        self.verts = rigging.animate(self.avatar, self.clip.poses,
                                     self.clip.trans, device=dev)

    def screen_attrs(self, frames, shading):
        from tpubody_torch.render import video

        return video._screen_and_attrs(
            self.verts[frames], self.faces, self.colors, self.cam,
            VIDEO_SIZE, VIDEO_SIZE, video.DEFAULT_FOCAL, shading)


def check_raster_case(name, verts, faces, attrs, H, W, total_chunks, sx, sy):
    """Bin, run the kernel and its plain version on the same table, and
    hold them together -> (attr max |d|, overflow, hits)."""
    import torch

    from tpubody_torch.render import raster, tiled_raster as TR

    table, cstarts, nvalid, overflow, meta = TR._bin_fused(
        verts, faces, attrs, H, W, total_chunks, sx, sy)
    fb, dl = meta["fb"], meta["depth_levels"]
    win, attr = TR.fused_raster(table, cstarts, H, W, fb, dl)
    torch.cuda.synchronize()
    win_p, attr_p = TR.fused_raster_reference(table, cstarts, H, W, fb, dl)
    C = attrs.shape[-1]
    if win.shape != (verts.shape[0], H, W) or \
            attr.shape != (verts.shape[0], C, H, W):
        raise RuntimeError(f"{name}: shapes {win.shape} {attr.shape}")
    n_diff = int((win != win_p).sum())
    hits = int((win != raster.INT32_MAX).sum())
    err = (attr - attr_p).abs().max().item()
    bar = RASTER_ATTR_REL * max(attr_p.abs().max().item(), 1e-30)
    ok = n_diff == 0 and err <= bar and bool(torch.isfinite(attr).all())
    log(f"  {name:34s} C={C:2d} chunks={int(nvalid.sum()):6d}"
        f" overflow={int(overflow.sum()):4d} hits={hits:8d}"
        f" win diffs={n_diff} attr max|d|={err:.3e}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"fused_raster disagrees with its plain version: "
                           f"{name}")
    return err, int(overflow.sum()), hits


def phase_raster_kernels(setup):
    import torch

    dev = setup.dev
    worst = 0.0
    # (a) two frames of the clip at full width, every pass, both shadings.
    for shading in ("gouraud", "phong"):
        screen, attrs = setup.screen_attrs([0, 37], shading)
        for i, (faces, sx, sy, tc) in enumerate(setup.passes):
            name = f"clip 1024^2 {shading} pass {i} F={faces.shape[0]}"
            err, ov, hits = check_raster_case(
                name, screen, faces, attrs, VIDEO_SIZE, VIDEO_SIZE, tc, sx,
                sy)
            worst = max(worst, err)
            if hits == 0:
                raise RuntimeError(f"{name}: nothing was covered")
    # (b) random scenes, (c) a 24-channel stack.
    for seed, n_faces, ext, C in ((4, 40, 12, 6), (5, 30, 10, 3),
                                  (6, 40, 12, 24)):
        v, f, a = random_scene(64, 128, n_faces, ext, seed, C)
        err, ov, hits = check_raster_case(
            f"random scene seed {seed} 64x128",
            torch.as_tensor(v, device=dev)[None], torch.as_tensor(f, device=dev),
            torch.as_tensor(a, device=dev)[None], 64, 128, 8 * 5, 2, 5)
        worst = max(worst, err)
        if ov or not hits:
            raise RuntimeError("random scene: unexpected overflow or no hit")
    # (d) 400 faces piled on one tile (13 chunks) with a budget of 8.
    rng = np.random.default_rng(3)
    v = np.stack([rng.uniform(4, 100, 1200), rng.uniform(1, 6, 1200),
                  rng.uniform(1, 2, 1200)], 1).astype(np.float32)
    f = np.arange(1200).reshape(400, 3).astype(np.int32)
    a = rng.uniform(size=(1200, 3)).astype(np.float32)
    err, ov, hits = check_raster_case(
        "overflowing budget 64x128",
        torch.as_tensor(v, device=dev)[None], torch.as_tensor(f, device=dev),
        torch.as_tensor(a, device=dev)[None], 64, 128, 8, 2, 5)
    if ov == 0:
        raise RuntimeError("the overflow case dropped no face")
    return max(worst, err)


class FrameCollector:
    """Stands in for the MP4 encoder where cv2 is missing, and records the
    frames handed to the writer either way (the methods of
    tpubody_torch.render.video.VideoWriter)."""

    frames = []
    inner_cls = None      # the real VideoWriter where cv2 imports

    def __init__(self, path, fps=30.0, size=(VIDEO_SIZE, VIDEO_SIZE)):
        self.path = path
        self.inner = (FrameCollector.inner_cls(path, fps=fps, size=size)
                      if FrameCollector.inner_cls else None)

    def write(self, frame):
        from tpubody_torch.render import video

        FrameCollector.frames.append(("rgb", video.quantize_u8(frame).copy()))
        if self.inner:
            self.inner.write(frame)

    def write_i420(self, planes):
        FrameCollector.frames.append(("i420", np.array(planes)))
        if self.inner:
            self.inner.write_i420(planes)

    def close(self):
        if self.inner:
            self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def i420_luma(planes):
    return planes[: planes.shape[0] * 2 // 3]


def check_frames(frames, n, bbox, what):
    """n frames of 1024x1024, not all background, body pixels inside the
    projected bbox, consecutive frames different."""
    if len(frames) != n:
        raise RuntimeError(f"{what}: {len(frames)} frames, expected {n}")
    x0, x1, y0, y1 = bbox
    prev = None
    for kind, f in frames:
        if kind == "i420":
            if f.shape != (VIDEO_SIZE * 3 // 2, VIDEO_SIZE) or \
                    f.dtype != np.uint8:
                raise RuntimeError(f"{what}: I420 frame {f.shape} {f.dtype}")
            body = i420_luma(f) < 235          # white background: Y = 235
        else:
            if f.shape != (VIDEO_SIZE, VIDEO_SIZE, 3) or f.dtype != np.uint8:
                raise RuntimeError(f"{what}: RGB frame {f.shape} {f.dtype}")
            body = (f < 255).any(axis=-1)
        ys, xs = np.nonzero(body)
        if ys.size < 10000:
            raise RuntimeError(f"{what}: a frame shows no body")
        if xs.min() < x0 - 1 or xs.max() > x1 + 1 or ys.min() < y0 - 1 \
                or ys.max() > y1 + 1:
            raise RuntimeError(
                f"{what}: body pixels x [{xs.min()}, {xs.max()}] y "
                f"[{ys.min()}, {ys.max()}] outside the projected bbox {bbox}")
        if prev is not None and np.array_equal(prev, f):
            raise RuntimeError(f"{what}: two consecutive frames are equal")
        prev = f


def phase_video(setup, workdir):
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    log(f"  cv2 {'imports: frames are encoded to MP4' if have_cv2 else 'is missing: the encoder is replaced by a frame collector'}")
    FrameCollector.inner_cls = video.VideoWriter if have_cv2 else None
    real_writer = video.VideoWriter
    video.VideoWriter = FrameCollector
    try:
        bb = video.screen_bbox(setup.verts, setup.cam, VIDEO_SIZE, VIDEO_SIZE,
                               video.DEFAULT_FOCAL).cpu().numpy()
        bbox = (float(bb[0]), float(bb[1]), float(bb[2]), float(bb[3]))
        passes = len(setup.passes)
        log(f"  plan: base {setup.passes[0][0].shape[0]} faces, spans "
            f"{setup.passes[0][1]}x{setup.passes[0][2]}, "
            f"{setup.passes[0][3]} chunks; rungs "
            f"{[(int(p[0].shape[0]), p[3]) for p in setup.passes[1:]]}; "
            f"fragment buckets {len(setup.plan['large_buckets'])}")
        if passes != 3 or setup.plan["large_buckets"]:
            raise RuntimeError("the plan is not base + two ladder rungs")

        out = os.path.join(workdir, "clip.mp4")
        results = {}
        for run in ("cold", "warm"):
            FrameCollector.frames = []
            native.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            animate.animate_from_amass(setup.avatar_path, setup.clip_path,
                                       out, stride=1, size=VIDEO_SIZE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(native.LAUNCHES)
            want = (VIDEO_FRAMES // 8) * passes
            log(f"  {run}: {VIDEO_FRAMES} frames in {wall:.3f} s = "
                f"{VIDEO_FRAMES / wall:.2f} frames/s; launches {launches}")
            if launches["fused_raster"] != want:
                raise RuntimeError(
                    f"fused_raster launched {launches['fused_raster']} times "
                    f"on the video path, expected {want}")
            kinds = {k for k, _ in FrameCollector.frames}
            check_frames(FrameCollector.frames, VIDEO_FRAMES, bbox,
                         f"animate_from_amass ({run})")
            if have_cv2 and os.path.getsize(out) < 10000:
                raise RuntimeError("the MP4 is missing or trivial")
            results[run] = dict(wall_s=wall, fps=VIDEO_FRAMES / wall,
                                launches=launches, transfer=sorted(kinds))
        if have_cv2:
            log(f"  MP4: {os.path.getsize(out)} bytes")

        # The uint8-RGB full-frame transfer, 8 frames.
        from tpubody_torch.io import motion

        FrameCollector.frames = []
        clip8 = motion.MotionClip(setup.clip.poses[:8], setup.clip.trans[:8],
                                  setup.clip.fps)
        animate.animate_video(setup.avatar, clip8,
                              os.path.join(workdir, "clip8.mp4"),
                              size=VIDEO_SIZE, i420_transfer=False,
                              crop_transfer=False)
        check_frames(FrameCollector.frames, 8, bbox, "animate_video (RGB)")
        if {k for k, _ in FrameCollector.frames} != {"rgb"}:
            raise RuntimeError("the RGB transfer produced I420 frames")
        log("  8 frames with i420_transfer=False, crop_transfer=False: ok")
    finally:
        video.VideoWriter = real_writer
        FrameCollector.frames = []
    results["have_cv2"] = have_cv2
    return results


def phase_oracle(setup):
    import torch

    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    size, focal = 256, 625.0
    dev = setup.dev
    av = setup.avatar
    plan, pt, _ = animate._tiled_plan(av.v_template, av.faces, setup.cam_t,
                                      size, focal, 2, dev)
    bg = torch.ones((size, size, 3), dtype=torch.float32, device=dev)
    verts = setup.verts[[0, VIDEO_FRAMES - 1]]
    tiled = video.render_frames_tiled(
        verts, pt["small_faces"], pt["large_buckets"], setup.faces,
        setup.colors, setup.cam, bg, height=size, width=size, focal=focal,
        max_chunks=plan["max_chunks"], span_x=plan["span_x"],
        span_y=plan["span_y"], total_chunks=plan["total_chunks"],
        large_windows=plan["large_windows"], ladder_faces=pt["ladder_faces"],
        ladder_specs=plan["ladder_specs"], to_uint8=False)
    w = video.auto_window(av.v_template, av.faces, setup.cam_t, size, size,
                          focal)
    frag = video.render_frames(verts, setup.faces, setup.colors, setup.cam,
                               bg, height=size, width=size, focal=focal,
                               window=w)
    torch.cuda.synchronize()
    agree = ((tiled - frag).abs() <= ORACLE_ATOL).float().mean().item()
    body = (frag < 1.0).any(dim=-1).float().mean().item()
    log(f"  tiled vs fragment renderer at {size}^2 (window {w}): "
        f"{agree * 100:.3f}% of values within {ORACLE_ATOL}; body covers "
        f"{body * 100:.1f}% of the frame")
    if agree <= ORACLE_AGREE or body < 0.02:
        raise RuntimeError("the tiled renderer disagrees with the fragment "
                           "renderer")
    return agree


class LayerTimer:
    """CUDA-event spans around the layers of a render block, taken inside
    one run of the block: each wrapped function records an event on the
    stream before and after its call, so a layer's time is the card's time
    between the two, launch gaps included, and the layers are disjoint
    parts of the block's total."""

    def __init__(self):
        self.spans = []               # (name, start event, end event)

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.spans.append((name, start, end))
            return out

        return timed

    def ms(self):
        """name -> list of span times, in call order."""
        out = {}
        for name, start, end in self.spans:
            out.setdefault(name, []).append(start.elapsed_time(end))
        return out


def phase_video_timing(setup, workdir, video_res, raster_err):
    """CUDA-event times per layer of one 8-frame block, and the kernel
    against its plain version and its bound."""
    import torch

    from tpubody_torch.mesh import rigging
    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import tiled_raster as TR
    from tpubody_torch.render import video

    dev = setup.dev
    block = setup.verts[:8].contiguous()
    H = W = VIDEO_SIZE
    n_pass = len(setup.passes)
    split = {}
    split["skinning_64_frames"] = time_ms(lambda: rigging.animate(
        setup.avatar, setup.clip.poses, setup.clip.trans, device=dev),
        iters=10, warmup=2)

    # The block's layers, inside the block: the same render_block that
    # animate_video drives, with its layers wrapped in event spans.
    render_block, chunk, i420 = animate._block_renderer(
        setup.avatar, None, setup.cam_t, VIDEO_SIZE, video.DEFAULT_FOCAL,
        None, 8, i420=True, device=dev)
    iters = 10
    for _ in range(2):
        render_block(block)
    timer = LayerTimer()
    patched = [(video, "_screen_and_attrs", "transform_normals"),
               (TR, "_bin_fused", "binning"),
               (TR, "fused_raster", "fused_raster"),
               (video, "_composite", "composite"),
               (video, "_shade_and_pack", "shade_i420")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    try:
        for mod, attr, name in patched:
            setattr(mod, attr, timer.wrap(name, getattr(mod, attr)))
        split["render_block"] = time_ms(lambda: render_block(block),
                                        iters=iters, warmup=0)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    spans = timer.ms()
    for name, times in spans.items():
        split[name] = sum(times) / iters
    # what is left: the depth rebuilt from the winning key in
    # render_attrs_tiled, and the gaps between the layers
    split["depth_from_key_and_gaps"] = split["render_block"] - sum(
        split[name] for name in spans)
    if len(spans["binning"]) != iters * n_pass:
        raise RuntimeError("the block did not bin once per pass")

    # The kernel alone, per pass: back-to-back launches on the block's own
    # tables (L2 warm), its plain version, and its bound.
    screen, attrs = setup.screen_attrs(slice(0, 8), "gouraud")
    passes = []
    for i, (faces, sx, sy, tc) in enumerate(setup.passes):
        table, cstarts, nvalid, _, meta = TR._bin_fused(
            screen, faces, attrs, H, W, tc, sx, sy)
        fb, dl = meta["fb"], meta["depth_levels"]
        k_ms = time_ms(lambda: TR.fused_raster(table, cstarts, H, W, fb, dl),
                       iters=20, warmup=3)
        p_ms = time_ms(lambda: TR.fused_raster_reference(
            table, cstarts, H, W, fb, dl), iters=2, warmup=1)
        B, MAXC, CF, G, _ = table.shape
        chunks = int(torch.clamp(nvalid, max=MAXC).sum())
        nbytes = chunks * CF * G * 3 * 4 + cstarts.numel() * 4 \
            + B * H * W * 4 * (1 + G - 5)
        ops = chunks * CF * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = ops / PEAK_FP32 * 1e3
        passes.append(dict(
            faces=int(faces.shape[0]), spans=[sx, sy], total_chunks=tc,
            valid_chunks=chunks,
            bin_ms_in_block=sum(spans["binning"][i::n_pass]) / iters,
            ms_in_block=sum(spans["fused_raster"][i::n_pass]) / iters,
            ms=k_ms, plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))

    frames = render_block(block)
    host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
    split["copy_to_host"] = time_ms(
        lambda: host.copy_(frames, non_blocking=True), iters=10, warmup=2)
    if video_res["have_cv2"]:
        planes = host.numpy()
        with video.VideoWriter(os.path.join(workdir, "mux.mp4"),
                               size=(VIDEO_SIZE, VIDEO_SIZE)) as wr:
            t0 = time.perf_counter()
            for f in planes:
                wr.write_i420(f)
            split["mux_host_8_frames"] = (time.perf_counter() - t0) * 1e3
    else:
        split["mux_host_8_frames"] = None
    res = dict(frames_per_s=video_res["warm"]["fps"],
               frames_per_s_cold=video_res["cold"]["fps"],
               frames=VIDEO_FRAMES, size=VIDEO_SIZE, block=chunk,
               transfer=video_res["warm"]["transfer"],
               have_cv2=video_res["have_cv2"],
               block_split_ms=split, passes=passes)
    log(f"  video: {res['frames_per_s']:.2f} frames/s warm "
        f"({res['frames_per_s_cold']:.2f} cold); ms per 8-frame block: "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                    for k, v in split.items()))
    for i, p in enumerate(passes):
        log(f"  pass {i}: {p}")
    log(json.dumps({"video": res}))

    base = passes[0]
    return {
        "name": "fused_raster",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_raster.cu",
        "replaces": "tpubody/render/pallas_raster.py:600",
        "replaces_fn": "tpubody/render/pallas_raster.py::_fused_kernel",
        "shape": {"B": 8, "H": H, "W": W, "C": 3, "CF": TR.CF_FUSED,
                  "faces": base["faces"], "valid_chunks": base["valid_chunks"],
                  "pass": "base (pass 0 of 3)"},
        "launches": video_res["warm"]["launches"]["fused_raster"],
        "max_abs_err": raster_err,
        "max_err": raster_err,
        "ms": base["ms"],
        "kernel_ms": base["ms"],
        "plain_ms": base["plain_ms"],
        "bound_ms": base["bound_ms"],
        "bound_by": base["bound_by"],
        "library_ms": None,
        "passes": passes,
    }


def phase_video_profile(setup, workdir):
    """torch.profiler over one warm pass of the video path: the card's busy
    share of the wall time and its time by kernel.  Not part of the default
    run (``--phases video,vprofile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpubody_torch.pipelines import animate

    out = os.path.join(workdir, "profile.mp4")

    def run():
        animate.animate_from_amass(setup.avatar_path, setup.clip_path, out,
                                   stride=1, size=VIDEO_SIZE)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    log(f"  profiled pass: {VIDEO_FRAMES} frames in {wall_ms:.1f} ms under "
        f"the profiler; device kernels busy {busy_ms:.1f} ms = "
        f"{busy_ms / wall_ms * 100:.1f}% of the wall time (idle "
        f"{100 - busy_ms / wall_ms * 100:.1f}%)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {count:6d} x  {key[:90]}")
    log(json.dumps({"video_profile": {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "top": [{"kernel": k[:120], "ms": ms, "count": c}
                for k, ms, c in rows[:12]]}}))


# -- the reconstruct path ----------------------------------------------------
def demo_pose(n_joints=52, seed=0):
    """The demo fixture's pose: upright in image coordinates, arms a little
    below the T-pose and clear of the torso, knees slightly bent, a small
    seeded jitter."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((n_joints, 3))
    pose[0] = [np.pi, 0.0, 0.0]
    pose[16] = [0.0, 0.0, -0.22]
    pose[17] = [0.0, 0.0, 0.22]
    pose[18] = [0.0, 0.0, -0.12]
    pose[19] = [0.0, 0.0, 0.12]
    pose[4] = [0.08, 0.0, 0.0]
    pose[5] = [0.08, 0.0, 0.0]
    pose[1:22] += rng.normal(scale=0.015, size=(21, 3))
    return pose


class ReconSetup:
    """The demo fixture in memory on ``dev``: the two humanoid models at
    SMPL's size, the fit (pose, betas, a camera centred on the posed body:
    focal 5000 at 1024^2), the posed vertices, and the photo mask: the same
    body at PHOTO_BETAS through the same camera."""

    def __init__(self, dev, size, n_verts=6890):
        import torch

        from tpubody_torch.models import humanoid, smpl
        from tpubody_torch.pipelines import reconstruct as rec
        from tpubody_torch.render import bodymaps

        self.dev, self.size = dev, size
        self.smplh = humanoid.humanoid(52, n_verts, device=dev)
        self.smpl = humanoid.humanoid(24, n_verts, device=dev)
        pose = demo_pose(52, 0)

        def posed(betas):
            return smpl.forward(
                self.smplh,
                torch.as_tensor(pose, dtype=torch.float32, device=dev),
                torch.as_tensor(betas, dtype=torch.float32, device=dev)).verts

        self.verts = posed(DEMO_BETAS)
        v = self.verts.cpu().numpy().astype(np.float64)
        focal = 5000.0 * size / 1024.0
        center = np.array([size / 2.0, size / 2.0])
        c = (v.min(axis=0) + v.max(axis=0)) / 2.0
        extent = float((v.max(axis=0) - v.min(axis=0))[:2].max()) * 1.35
        cam_t = np.array([-c[0], -c[1],
                          extent * focal / (0.85 * size) - c[2]])
        self.fit = rec.FitResult(
            shape=DEMO_BETAS, pose=pose.reshape(-1), camera_center=center,
            camera_rotation=np.eye(3), camera_translation=cam_t,
            camera_fx=focal)
        photo = bodymaps.render_body_maps(
            posed(PHOTO_BETAS), self.smplh.faces, self.smpl.weights, cam_t,
            center, size, size, focal=focal, device=dev)
        self.mask = photo.mask.cpu().numpy()
        self.mask_u8 = self.mask.astype(np.uint8) * 255

    def scene(self):
        """The body-map passes on the card: screen-space vertices, and
        (name, faces, attrs) of the front, back and all-faces pass."""
        import torch

        from tpubody_torch.render import bodymaps, raster

        dev = self.dev

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        screen = bodymaps.project_to_screen(
            self.verts, f32(self.fit.camera_translation),
            f32(self.fit.camera_center), self.fit.camera_fx)
        faces_np = np.asarray(self.smplh.faces).astype(np.int32)
        front, back = bodymaps._front_back_faces(self.verts, faces_np)
        allf = torch.as_tensor(faces_np, device=dev)
        return screen, [
            ("front", front,
             (raster.vertex_normals(self.verts, front) + 1.0) * 0.5),
            ("back", back,
             (raster.vertex_normals(self.verts, back) + 1.0) * 0.5),
            ("all", allf, self.smpl.weights.to(dev))]

    def run(self, workdir, timer=None, detail=None, cache=False):
        """The helper of the reconstruct pipeline on this fixture ->
        ((J_2d, stitch weights, front depth, back depth), keep, timer)."""
        from tpubody_torch.pipelines import reconstruct as rec
        from tpubody_torch.utils.cache import StageCache
        from tpubody_torch.utils.profiling import StageTimer

        timer = timer or StageTimer()
        keep = {}
        out = rec._device_stages(
            self.mask_u8, self.fit, self.smplh, self.smpl,
            StageCache(workdir, enabled=cache), timer, detail, keep=keep)
        return out, keep, timer


def zbuffer_plan(screen, faces, H, W):
    """Spans, a chunk capacity under which no tile of this pass overflows,
    and the fused path's chunk budget ->
    (span_x, span_y, max_chunks, total_chunks)."""
    import torch

    from tpubody_torch.render import bodymaps, tiled_raster as TR

    sx, sy, tc = bodymaps._tiled_plan(screen, faces, H, W)
    nc = 4
    while int(TR.bin_faces(screen[None], faces, H, W, nc, sx, sy)[2].sum()):
        nc *= 2
        if nc > 32:
            raise RuntimeError("a tile holds more than 4096 faces")
    torch.cuda.synchronize()
    return sx, sy, nc, tc


def check_zbuffer_case(name, verts, faces, H, W, nc, sx, sy):
    """Bin, run the kernel and its plain version on the same table and hold
    them together -> (max |key difference|, overflow, hits, zbuf)."""
    import torch

    from tpubody_torch.render import raster, tiled_raster as TR

    table, nchunks, overflow = TR.bin_faces(verts, faces, H, W, nc, sx, sy)
    fb = raster._face_bits(int(faces.shape[0]))
    dl = 1 << (31 - fb)
    z = TR.zbuffer(table, nchunks, H, W, fb, dl)
    torch.cuda.synchronize()
    z_p = TR.zbuffer_reference(table, nchunks, H, W, fb, dl)
    if z.shape != (verts.shape[0], H, W) or z.dtype != torch.int32:
        raise RuntimeError(f"{name}: zbuf {tuple(z.shape)} {z.dtype}")
    n_diff = int((z != z_p).sum())
    err = float((z.to(torch.int64) - z_p.to(torch.int64)).abs().max())
    hits = int((z != raster.INT32_MAX).sum())
    log(f"  {name:34s} NC={nc:2d} chunks={int(nchunks.sum()):5d}"
        f" overflow={int(overflow.sum()):4d} hits={hits:8d}"
        f" diffs={n_diff} {'ok' if n_diff == 0 else 'FAIL'}")
    if n_diff:
        raise RuntimeError(f"zbuffer disagrees with its plain version: "
                           f"{name}")
    return err, int(overflow.sum()), hits, z


def phase_zbuffer(recon):
    """-> the largest |key difference| between the kernel and its plain
    version over the cases (0, or the phase has raised)."""
    import torch

    from tpubody_torch.render import raster, tiled_raster as TR

    dev = recon.dev
    H = W = recon.size
    total = 0.0
    # (a) the body-map scene at full width, and the fused kernel's face ids
    screen, passes = recon.scene()
    for name, faces, attrs in passes:
        sx, sy, nc, tc = zbuffer_plan(screen, faces, H, W)
        err, ov, hits, z = check_zbuffer_case(
            f"body maps {H}^2 {name} F={faces.shape[0]}", screen[None],
            faces, H, W, nc, sx, sy)
        total = max(total, err)
        if hits < 0.03 * H * W:
            raise RuntimeError(f"body maps {name}: nothing was covered")
        table, cstarts, _, ov2, meta = TR._bin_fused(
            screen[None], faces, attrs[None, :, :3].contiguous(), H, W, tc,
            sx, sy)
        win, _ = TR.fused_raster(table, cstarts, H, W, meta["fb"],
                                 meta["depth_levels"])
        fid_mask = (1 << meta["fb"]) - 1
        none = raster.INT32_MAX
        same = ((z == none) & (win == none)) | \
            ((z != none) & (win != none) & ((z & fid_mask) == (win & fid_mask)))
        share = same.float().mean().item()
        keys = (z == win).float().mean().item()
        log(f"    face ids equal to fused_raster's on {share * 100:.4f}% of "
            f"the pixels (whole keys on {keys * 100:.4f}%; fused overflow "
            f"{int(ov2.sum())})")
        if share < FACE_ID_AGREE:
            raise RuntimeError("zbuffer and fused_raster disagree on the "
                               "winning faces")
    # (b) random scenes of two frames, (c) under 64 faces: the wrapped key
    for seed, n_faces, ext, nc in ((0, 40, 12, 3), (4, 40, 12, 2),
                                   (7, 90, 10, 1)):
        v, f, _ = random_scene(64, 128, n_faces, ext, seed, 3)
        vb = torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                             device=dev)
        err, ov, hits, _ = check_zbuffer_case(
            f"random scene seed {seed} 64x128 x2", vb,
            torch.as_tensor(f, device=dev), 64, 128, nc, 2, 5)
        total = max(total, err)
        if ov or not hits:
            raise RuntimeError("random scene: unexpected overflow or no hit")
    # (d) 400 faces piled on one tile with a capacity of 128 and of 256
    rng = np.random.default_rng(3)
    v = np.stack([rng.uniform(4, 100, 1200), rng.uniform(1, 6, 1200),
                  rng.uniform(1, 2, 1200)], 1).astype(np.float32)
    f = np.arange(1200).reshape(400, 3).astype(np.int32)
    for nc in (1, 2):
        err, ov, hits, _ = check_zbuffer_case(
            "overflowing tile 64x128", torch.as_tensor(v, device=dev)[None],
            torch.as_tensor(f, device=dev), 64, 128, nc, 2, 5)
        total = max(total, err)
        if ov == 0:
            raise RuntimeError("the overflow case dropped no face")
    return total


def check_recon_outputs(recon, out, keep, what, wsum_atol=WSUM_ATOL):
    """The gates of the reconstruct path on one run of the helper."""
    import torch

    J_2d, weights, front, back = out
    S = recon.size
    mask = recon.mask
    value = keep["value"]
    if tuple(value.shape) != (S, S, 30) or J_2d.shape != (24, 2):
        raise RuntimeError(f"{what}: shapes {tuple(value.shape)} {J_2d.shape}")
    body = ~(value[..., :3] == 1.0).all(dim=-1)
    share = body.float().mean().item()
    bg = value[~body]
    wsum = value[..., 6:][body].sum(dim=-1)
    werr = (wsum - 1.0).abs().max().item()
    if not (0.05 < share < 0.6) or not bool((bg[:, :3] == 1.0).all()) \
            or not bool((bg[:, 6:] == 1.0).all()) or werr > wsum_atol:
        raise RuntimeError(f"{what}: value map: body share {share}, weights "
                           f"sum off by {werr}")
    warp = keep["warp"]
    m = torch.as_tensor(mask, device=warp.device)
    filled = (warp.abs().sum(dim=-1) > 0)
    if not bool(filled[m].all()) or bool((warp[~m] != 0).any()):
        raise RuntimeError(f"{what}: the warped map does not fill the mask")
    moved = int((body.cpu().numpy() != mask).sum())
    pcg = keep["pcg"]
    if not pcg["relative_residual"] < PCG_RELRES:
        raise RuntimeError(f"{what}: PCG relative residual "
                           f"{pcg['relative_residual']}")
    for d in (front, back):
        if d.shape != (S, S) or not np.isfinite(d).all() \
                or (d[~mask] != 0).any() or not d[mask].max() > 0:
            raise RuntimeError(f"{what}: bad depth map")
    if weights.shape != (S, S, 24) or not np.isfinite(weights).all():
        raise RuntimeError(f"{what}: bad stitch weights")
    log(f"  {what}: body {share * 100:.2f}% of the frame, photo mask "
        f"{mask.mean() * 100:.2f}% ({moved} pixels differ); weights sum to 1 "
        f"within {werr:.2e}; PCG {pcg['iterations']} iterations, relative "
        f"residual {pcg['relative_residual']:.3e}; depth range front "
        f"{front.max():.3f} back {back.max():.3f}")


def phase_reconstruct(recon, workdir):
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import reconstruct as rec
    from tpubody_torch.render import tiled_raster as TR

    dev = recon.dev
    S = recon.size
    screen, passes = recon.scene()
    _, front_faces, front_attrs = passes[0]
    sx, sy, nc, _ = zbuffer_plan(screen, front_faces, S, S)

    # The main path: the helper with the cache off, then the front normal
    # map once more through the z-buffer rasterizer.
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, keep, timer = recon.run(workdir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tiled, overflow = TR.rasterize_tiled(
        screen, front_faces, front_attrs, S, S, max_chunks=nc, span_x=sx,
        span_y=sy, return_overflow=True)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    log(f"  helper at {S}^2 (cold): {wall:.3f} s; launches {launches}")
    log("  " + timer.report().replace("\n", "\n  "))
    if launches["fused_raster"] != 3 or launches["zbuffer"] != 1:
        raise RuntimeError(f"the reconstruct path launched {launches}, "
                           f"expected fused_raster 3 and zbuffer 1")
    check_recon_outputs(recon, out, keep, f"reconstruct {S}^2")

    # rasterize_tiled's map against the fused kernel's front normal map
    fused = keep["value"][..., :3]
    fmask = ~(fused == 1.0).all(dim=-1)
    tmap = torch.where(tiled.mask[..., None], tiled.attrs,
                       torch.ones_like(tiled.attrs))
    same_mask = (tiled.mask == fmask).float().mean().item()
    close = ((tmap - fused).abs().amax(dim=-1) <= TILED_MAP_ATOL
             ).float().mean().item()
    log(f"  rasterize_tiled front normals vs the fused map: coverage equal "
        f"on {same_mask * 100:.4f}% of the pixels, values within "
        f"{TILED_MAP_ATOL} on {close * 100:.4f}%; overflow {int(overflow)}")
    if int(overflow) or min(same_mask, close) < TILED_MAP_AGREE:
        raise RuntimeError("rasterize_tiled disagrees with the fused map")

    # A small input: the same path on the card and on the CPU, fp32.
    small = ReconSetup(dev, RECON_SMALL)
    small_cpu = ReconSetup("cpu", RECON_SMALL)
    if not np.array_equal(small.mask, small_cpu.mask):
        n = int((small.mask != small_cpu.mask).sum())
        log(f"  {RECON_SMALL}^2: the photo masks differ on {n} pixels; the "
            f"CPU's is used for both")
        small.mask, small.mask_u8 = small_cpu.mask, small_cpu.mask_u8
    out_g, keep_g, _ = small.run(workdir)
    out_c, keep_c, _ = small_cpu.run(workdir)
    check_recon_outputs(small, out_g, keep_g, f"card {RECON_SMALL}^2",
                        WSUM_ATOL_SMALL)
    rng = float(out_c[2].max() - out_c[2].min())
    sil_g = (keep_g["value"][..., :3] == 1.0).all(dim=-1).cpu()
    sil_c = (keep_c["value"][..., :3] == 1.0).all(dim=-1)
    same_sil = bool(torch.equal(sil_g, sil_c))
    # Tight bars on TIGHT_SHARE of the pixels, not all: where a warped
    # position lies within float32 rounding of a pixel boundary, the MVC's
    # transcendentals (libm on the CPU, CUDA's on the card) round it to
    # neighbouring pixels, so single pixels of the scatter take their value
    # from the next source pixel, and the depth bends a little around them.
    d_front = np.abs(out_g[2] - out_c[2])
    d_back = np.abs(out_g[3] - out_c[3])
    d_w = np.abs(out_g[1] - out_c[1]).max(axis=-1)
    depth_ok = float(((d_front <= DEPTH_REL * rng)
                      & (d_back <= DEPTH_REL * rng)).mean())
    w_ok = float((d_w <= WEIGHT_ATOL).mean())
    log(f"  fp32 card vs CPU at {RECON_SMALL}^2: silhouettes "
        f"{'equal' if same_sil else 'differ'}; depth max|d| front "
        f"{d_front.max():.3e} back {d_back.max():.3e} (range {rng:.3f}), "
        f"mean {d_front.mean():.3e}, within {DEPTH_REL} of the range on "
        f"{depth_ok * 100:.4f}% of the pixels; stitch weights max|d| "
        f"{d_w.max():.3e}, within {WEIGHT_ATOL} on {w_ok * 100:.4f}%; PCG "
        f"iterations {keep_g['pcg']['iterations']} vs "
        f"{keep_c['pcg']['iterations']}")
    if not np.array_equal(out_g[0], out_c[0]):
        raise RuntimeError("projected joints differ between card and CPU")
    if max(d_front.mean(), d_back.mean()) > CHAIN_MEAN_REL * rng:
        raise RuntimeError("the card's depth disagrees with the CPU's")
    if same_sil and (min(depth_ok, w_ok) < TIGHT_SHARE
                     or max(d_front.max(), d_back.max())
                     > CHAIN_MEAN_REL * rng
                     or abs(keep_g["pcg"]["iterations"]
                            - keep_c["pcg"]["iterations"]) > 2):
        raise RuntimeError("the card disagrees with the CPU on equal "
                           "silhouettes")

    # The public entry point runs the same stages and stops at the stitch.
    rgb = np.zeros((RECON_SMALL, RECON_SMALL, 3), np.uint8)
    try:
        rec.reconstruct(rgb, rgb, small.mask_u8, small.fit, small.smplh,
                        small.smpl, cache=False)
    except NotImplementedError as e:
        log(f"  reconstruct() ran its device stages and raised: "
            f"{str(e)[:60]}...")
    else:
        raise RuntimeError("reconstruct() returned: the stitch stage is "
                           "not ported")
    return dict(launches=launches, wall_s=wall, pcg=keep["pcg"])


class EventStageTimer:
    """The interface of tpubody_torch.utils.profiling.StageTimer with
    CUDA-event spans: an event is recorded on the stream when a stage
    begins and when it ends, nothing synchronises in between, and a
    stage's time is the card's clock between the two (the host's work and
    the launch gaps inside the stage included)."""

    def __init__(self):
        self.records = []
        self.spans = []

    def stage(self, name):
        import contextlib

        import torch

        @contextlib.contextmanager
        def span():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.spans.append((name, start, end))

        return span()

    def ms(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def device_busy(fn):
    """Run fn under torch.profiler -> (device busy ms, number of device
    kernels and copies, the five largest rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy, sum(r[2] for r in rows), rows[:5]


def phase_recon_timing(recon, workdir, recon_res, zbuffer_diffs):
    """Stage and substage times of a warm run of the helper, the card's
    busy share of its two long stages, and the two raster kernels alone at
    the body-map shapes."""
    import torch

    from tpubody_torch.image import warp as warp_lib
    from tpubody_torch.render import raster, tiled_raster as TR
    from tpubody_torch.solve import normal2depth as n2d

    dev = recon.dev
    S = recon.size
    timer = EventStageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, keep, _ = recon.run(workdir, timer=timer, detail=timer)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = timer.ms()
    log(f"  helper at {S}^2 (warm): {wall_ms:.1f} ms on the host's clock; "
        f"CUDA-event spans, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # The card's busy share of the two long stages.
    value, mask_dev = keep["value"], torch.as_tensor(recon.mask, device=dev)
    warped6 = keep["warp"][..., :6].contiguous()
    busy = {}
    for name, fn in (
            ("normal2depth", lambda: n2d.normal2depth(warped6, mask_dev)),
            ("warp", lambda: warp_lib.warp_stage(recon.mask_u8, value))):
        fn()
        span_ms = time_ms(fn, iters=2, warmup=0)
        busy_ms, count, top = device_busy(fn)
        busy[name] = dict(span_ms=span_ms, device_busy_ms=busy_ms,
                          device_ops=count,
                          gap_share=1.0 - busy_ms / span_ms)
        log(f"  {name}: {span_ms:.3f} ms a run; under the profiler {count} "
            f"device kernels and copies busy {busy_ms:.3f} ms: "
            f"{(1 - busy_ms / span_ms) * 100:.1f}% of the stage is gaps")
        for key, ms, c in top:
            log(f"    {ms:9.3f} ms {c:6d} x  {key[:90]}")

    # The kernels alone at the body-map shapes (back to back, L2 warm).
    screen, passes = recon.scene()
    zb, fused = [], []
    for name, faces, attrs in passes:
        sx, sy, nc, tc = zbuffer_plan(screen, faces, S, S)
        table, nchunks, _ = TR.bin_faces(screen[None], faces, S, S, nc, sx,
                                         sy)
        fb = raster._face_bits(int(faces.shape[0]))
        dl = 1 << (31 - fb)
        k_ms = time_ms(lambda: TR.zbuffer(table, nchunks, S, S, fb, dl),
                       iters=50, warmup=5)
        p_ms = time_ms(lambda: TR.zbuffer_reference(table, nchunks, S, S, fb,
                                                    dl), iters=3, warmup=1)
        bin_ms = time_ms(lambda: TR.bin_faces(screen[None], faces, S, S, nc,
                                              sx, sy), iters=5, warmup=1)
        chunks = int(nchunks.sum())
        nbytes = chunks * 5 * TR.CF * 4 * 4 + nchunks.numel() * 4 + S * S * 4
        ops = chunks * TR.CF * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        zb.append(dict(
            name=name, faces=int(faces.shape[0]), spans=[sx, sy],
            max_chunks=nc, live_chunks=chunks,
            live_tiles=int((nchunks > 0).sum()), table_mb=table.numel() * 4e-6,
            ms=k_ms, plain_ms=p_ms, bin_ms=bin_ms, bytes_ms=bytes_ms,
            ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))

        ftab, cstarts, nvalid, _, meta = TR._bin_fused(
            screen[None], faces, attrs[None].contiguous(), S, S, tc, sx, sy)
        ffb, fdl = meta["fb"], meta["depth_levels"]
        fk_ms = time_ms(lambda: TR.fused_raster(ftab, cstarts, S, S, ffb,
                                                fdl), iters=50, warmup=5)
        fp_ms = time_ms(lambda: TR.fused_raster_reference(
            ftab, cstarts, S, S, ffb, fdl), iters=2, warmup=1)
        _, MAXC, CFf, G, _ = ftab.shape
        fchunks = int(torch.clamp(nvalid, max=MAXC).sum())
        fbytes = fchunks * CFf * G * 3 * 4 + cstarts.numel() * 4 \
            + S * S * 4 * (1 + G - 5)
        fops = fchunks * CFf * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        fb_ms, fo_ms = fbytes / PEAK_BYTES * 1e3, fops / PEAK_FP32 * 1e3
        fused.append(dict(
            name=name, C=G - 5, total_chunks=tc, valid_chunks=fchunks,
            ms=fk_ms, plain_ms=fp_ms, bytes_ms=fb_ms, ops_ms=fo_ms,
            bound_ms=max(fb_ms, fo_ms),
            bound_by="bytes" if fb_ms >= fo_ms else "operations"))
    for p in zb:
        log(f"  zbuffer {p}")
    for p in fused:
        log(f"  fused_raster {p}")
    res = dict(size=S, wall_ms_warm=wall_ms, wall_s_cold=recon_res["wall_s"],
               stage_ms=stages, busy=busy, pcg=recon_res["pcg"], zbuffer=zb,
               fused_raster=fused)
    log(json.dumps({"reconstruct": res}))

    allp = zb[-1]
    entry = {
        "name": "zbuffer",
        "route": "cuda",
        "source": "tpubody_torch/csrc/zbuffer.cu",
        "replaces": "tpubody/render/pallas_raster.py:231",
        "replaces_fn": "tpubody/render/pallas_raster.py::_raster_kernel",
        "shape": {"B": 1, "H": S, "W": S, "CF": TR.CF,
                  "faces": allp["faces"], "max_chunks": allp["max_chunks"],
                  "live_chunks": allp["live_chunks"],
                  "pass": "all faces (the front pass is the one launched "
                          "on the main path)"},
        "launches": recon_res["launches"]["zbuffer"],
        "max_abs_err": zbuffer_diffs,
        "ms": allp["ms"],
        "plain_ms": allp["plain_ms"],
        "bound_ms": allp["bound_ms"],
        "bound_by": allp["bound_by"],
        "library_ms": None,
        "passes": zb,
    }
    return entry, fused


# -- the fused residual stage ------------------------------------------------
def seeded_chain(c_in, feats, n, seed, full_width):
    """n stride-1 Bottlenecks of the port on the CPU in float32.  Small
    chains draw every weight and BatchNorm statistic uniformly from [0.05,
    0.4] (tests/test_pallas_resnet.py); full-width ones take the model's
    seeded initialisation and seeded BatchNorm statistics."""
    import torch

    from tpubody_torch import bench
    from tpubody_torch.models import hmr

    mods = []
    for _ in range(n):
        mods.append(hmr.Bottleneck(c_in, feats, 1))
        c_in = feats * 4
    chain = torch.nn.Sequential(*mods).eval()
    if full_width:
        hmr.init_weights(chain, seed)
        bench.randomize_batchnorm(chain, seed)
    else:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for t in chain.state_dict().values():
                if t.dtype.is_floating_point:
                    t.copy_(torch.as_tensor(
                        rng.uniform(0.05, 0.4, tuple(t.shape)), dtype=t.dtype))
    return chain


def ulps2(scale):
    """Two bf16 ulps at the binade of `scale`."""
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def block_by_block(x_nhwc, fused):
    """Each block alone, on the plain version's input to it: what one launch
    computes, held to what the plain version computes from the same bits.
    -> (largest difference in units of 2 ulps of that block's largest
    output, smallest share of elements equal bit for bit)."""
    import torch

    from tpubody_torch.models import fused_resnet as FR

    h, worst_err, worst_equal = x_nhwc.to(torch.bfloat16), 0.0, 1.0
    for blk in fused.blocks():
        one = FR.FusedStage(*blk, *[getattr(fused, f)
                                    for f in FR.FIELDS[8:]], n_rest=0)
        a = FR.run_stage(h, one).float()
        h = FR.run_stage_reference(h, one)
        d = (a - h.float()).abs()
        worst_err = max(worst_err, d.max().item()
                        / ulps2(h.float().abs().max().item()))
        worst_equal = min(worst_equal, (d == 0).float().mean().item())
    return worst_err, worst_equal


def phase_stage(dev):
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import fused_resnet as FR

    # name, (B, H, W, C_in), features, blocks, x seed, weight seed, kind
    cases = [
        ("3 blocks, downsample 12x12", (2, 12, 12, 8), 4, 3, 1, 0, "small"),
        ("2 blocks, identity 8x8", (2, 8, 8, 16), 4, 2, 2, 0, "small"),
        ("single block 10x10", (1, 10, 10, 8), 4, 1, 3, 0, "small"),
        ("2 blocks, ragged 11x19", (2, 11, 19, 8), 4, 2, 4, 0, "small"),
        ("zero input 9x9", (1, 9, 9, 8), 4, 2, None, 5, "small"),
        ("stage 1 full width", (8, 56, 56, 64), 64, 3, 6, 7, "full"),
        ("stage 2 tail full width", (8, 28, 28, 512), 128, 3, 8, 9, "full"),
    ]
    for name, shape, feats, n, xseed, wseed, kind in cases:
        chain = seeded_chain(shape[-1], feats, n, wseed, kind == "full")
        fused = FR.fuse_stage(chain, list(range(n))).to(dev)
        x = np.zeros(shape, np.float32) if xseed is None else \
            np.random.default_rng(xseed).normal(size=shape).astype(np.float32)
        xd = torch.as_tensor(x, device=dev)
        before = native.LAUNCHES["fused_stage"]
        got = FR.run_stage(xd, fused)
        torch.cuda.synchronize()
        if native.LAUNCHES["fused_stage"] != before + n:
            raise RuntimeError(f"{name}: run_stage did not launch {n} times")
        want = FR.run_stage_reference(xd, fused)
        c_out = feats * 4
        if got.shape != shape[:3] + (c_out,) or got.dtype != torch.bfloat16:
            raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype}")
        g, w = got.float(), want.float()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        equal = (g == w).float().mean().item()
        with torch.no_grad():
            f32 = chain.to(dev)(xd.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        rel32 = (g - f32).abs().max().item() / f32.abs().max().item()
        worst_err, worst_equal = block_by_block(xd, fused)
        full = kind == "full"
        ok = (bool(torch.isfinite(g).all()) and scale > 0
              and worst_err <= 1.0 and worst_equal >= STAGE_EQUAL
              and err <= (STAGE_CHAIN_ULPS / 2 if full else 1) * ulps2(scale)
              and (full or equal >= STAGE_EQUAL)
              and rel32 < STAGE_LIB_REL)
        log(f"  {name:28s} {str(shape):18s} block by block: max|d| "
            f"{2 * worst_err:.1f} ulp, equal bits {worst_equal * 100:.4f}%;"
            f" chain: max|d|={err:.3e} of max {scale:.3e}"
            f" ({2 * err / ulps2(scale):.1f} ulp), equal bits"
            f" {equal * 100:.4f}%; vs the f32 chain rel {rel32:.2e}"
            f" {'ok' if ok else 'FAIL'}")
        if full:
            cpu = FR.run_stage_reference(xd.cpu(), fused.to("cpu")).float()
            log(f"    for scale: the plain version on the card vs on the CPU "
                f"(two sum orders), chain: equal bits "
                f"{(w.cpu() == cpu).float().mean().item() * 100:.4f}%, "
                f"max|d|={(w.cpu() - cpu).abs().max().item():.3e}")
        if not ok:
            raise RuntimeError(f"fused_stage disagrees with its plain "
                               f"version: {name}")


def hold_to_plain(x_nhwc, y, fused, name):
    """run_stage's output y on the whole batch x, held to the plain version,
    which takes the batch STAGE_CHUNK images at a time (it keeps a dozen
    float32 copies of what it is given).  Every chunk is compared with its
    rows of y, and the first also block by block.  -> max |kernel - plain|,
    the plain version's ms for the whole batch (CUDA events around each
    call, summed), the smallest share of equal elements of a chunk."""
    import torch

    from tpubody_torch.models import fused_resnet as FR

    B = x_nhwc.shape[0]
    FR.run_stage_reference(x_nhwc[:STAGE_CHUNK], fused)      # warm-up
    events, err, scale, equal = [], 0.0, 0.0, 1.0
    for i in range(0, B, STAGE_CHUNK):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = FR.run_stage_reference(x_nhwc[i:i + STAGE_CHUNK], fused)
        end.record()
        events.append((start, end))
        g, w = y[i:i + STAGE_CHUNK].float(), want.float()
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        equal = min(equal, (g == w).float().mean().item())
    torch.cuda.synchronize()
    plain_ms = sum(a.elapsed_time(b) for a, b in events)
    blk_err, blk_equal = block_by_block(x_nhwc[:STAGE_CHUNK], fused)
    ok = (scale > 0 and blk_err <= 1.0 and blk_equal >= STAGE_EQUAL
          and err <= STAGE_CHAIN_ULPS / 2 * ulps2(scale))
    log(f"  {name} vs the plain version, {B // STAGE_CHUNK} chunks of "
        f"{STAGE_CHUNK}: chain max|d|={err:.3e} of max {scale:.3e} "
        f"({2 * err / ulps2(scale):.1f} ulp), smallest share of equal bits "
        f"{equal * 100:.4f}%; first chunk block by block: max|d| "
        f"{2 * blk_err:.1f} ulp, equal bits {blk_equal * 100:.4f}%; plain "
        f"{plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"fused_stage disagrees with its plain version "
                           f"on the model: {name}")
    return err, plain_ms, equal


def phase_backbone(dev):
    """The fused stage on the serving model's activations and weights at
    batch 512, its times beside the library's, and the backbone's split
    -> the kernel line's entry."""
    import torch

    from tpubody_torch import bench, native
    from tpubody_torch.models import fused_resnet as FR
    from tpubody_torch.models import hmr

    B = BACKBONE_BATCH
    rng = np.random.default_rng(11)
    images = torch.as_tensor(
        rng.normal(size=(B, 224, 224, 3)).astype(np.float32), device=dev)
    model = hmr.create_hmr(dtype=torch.bfloat16, device=dev)
    bench.randomize_batchnorm(model.backbone, seed=12)
    bb = model.backbone

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item()

    with torch.inference_mode():
        x1 = bb.stem(images)                      # (512, 64, 56, 56)
        fused1 = FR.fuse_stage(bb.layer1, [0, 1, 2]).to(dev)
        fused2 = FR.fuse_stage(bb.layer2, [1, 2, 3]).to(dev)
        native.reset_launches()
        y1 = FR.run_stage(nhwc(x1), fused1)
        ref1 = bb.layer1(x1)
        x2 = bb.layer2[0](ref1)                   # (512, 512, 28, 28)
        y2 = FR.run_stage(nhwc(x2), fused2)
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        ref2 = bb.layer2[1:](x2)
        rel1, rel2 = rel(y1, nhwc(ref1)), rel(y2, nhwc(ref2))
        shapes = (tuple(y1.shape), tuple(y2.shape))
        finite = bool(torch.isfinite(y1.float()).all()
                      and torch.isfinite(y2.float()).all())
        log(f"  run_stage on the model at batch {B}: layer1 {shapes[0]} vs "
            f"the library rel {rel1:.3e}; layer2[1:] {shapes[1]} rel "
            f"{rel2:.3e}; launches {launches}")
        if shapes != ((B, 56, 56, 256), (B, 28, 28, 512)) or not finite:
            raise RuntimeError(f"bad outputs {shapes}, finite {finite}")
        if max(rel1, rel2) >= STAGE_LIB_REL:
            raise RuntimeError("the fused stage disagrees with the library's "
                               "bf16 chain")
        if launches["fused_stage"] != 6:
            raise RuntimeError(f"fused_stage launched "
                               f"{launches['fused_stage']} times, expected 6")
        del ref1, ref2
        # the same outputs against the plain version, on the same inputs
        # and weights, at the same batch
        plain = {1: hold_to_plain(nhwc(x1), y1, fused1, "layer1"),
                 2: hold_to_plain(nhwc(x2), y2, fused2, "layer2[1:]")}
        del y1, y2
        # the kernel on the model's own activations
        path_ms = {1: time_ms(lambda: FR.run_stage(nhwc(x1), fused1), 10, 2),
                   2: time_ms(lambda: FR.run_stage(nhwc(x2), fused2), 10, 2)}
        del x1, x2

    stages = {}
    for s in (1, 2):
        res = bench.fused_stage(s, batch=B, iters=20, device=dev)
        bytes_ms = res["bytes"] / PEAK_BYTES * 1e3
        ops_ms = res["flop"] / PEAK_BF16 * 1e3
        if res["parity_rel_err"] >= STAGE_LIB_REL:
            raise RuntimeError(f"bench.fused_stage({s}): parity "
                               f"{res['parity_rel_err']}")
        stages[str(s)] = dict(
            shape=res["shape"], batch=B, blocks=res["blocks"],
            launches_per_run=res["launches_per_run"],
            parity_rel_err=res["parity_rel_err"],
            ms=res["fused_ms"], ms_on_model=path_ms[s],
            library_ms=res["library_ms"],
            max_abs_err=plain[s][0], plain_ms=plain[s][1],
            plain_equal_share=plain[s][2],
            flop=res["flop"], bytes=res["bytes"], bytes_ms=bytes_ms,
            ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            tflops=res["flop"] / res["fused_ms"] * 1e-9)
        log(f"  stage {s}: {stages[str(s)]}")

    with torch.inference_mode():
        split = bench.backbone_split(bench.make_step(dev), images, 10)
    log(f"  backbone split at batch {B}, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; sum {sum(split.values()):.3f}")

    # the space-to-depth stem against the direct one, same state dict
    m7 = hmr.create_hmr(dtype=torch.float32, device=dev, seed=3)
    ms2d = hmr.create_hmr(dtype=torch.float32, device=dev, seed=3, stem="s2d")
    ms2d.load_state_dict(m7.state_dict())
    with torch.inference_mode():
        a, b = m7(images[:8]), ms2d(images[:8])
        stem_err = max((p - q).abs().max().item() for p, q in zip(a, b))
        feat_err = (m7.backbone.stem(images[:8])
                    - ms2d.backbone.stem(images[:8])).abs().max().item()
        s2d16 = hmr.create_hmr(dtype=torch.bfloat16, device=dev, stem="s2d")
        stem_ms = {
            "conv7": time_ms(lambda: bb.stem(images), 10, 2),
            "s2d": time_ms(lambda: s2d16.backbone.stem(images), 10, 2)}
    log(f"  s2d vs conv7 stem, fp32, 8 images: HMR outputs max|d|="
        f"{stem_err:.3e}, stem features max|d|={feat_err:.3e}; bf16 stem at "
        f"batch {B}: conv7 {stem_ms['conv7']:.3f} ms, s2d "
        f"{stem_ms['s2d']:.3f} ms")
    if stem_err > STEM_ATOL or feat_err > STEM_ATOL:
        raise RuntimeError("the s2d stem disagrees with conv7")
    log(json.dumps({"backbone": {
        "batch": B, "split_ms": split, "stem_ms": stem_ms,
        "fused_vs_library_rel": [rel1, rel2], "stages": stages}}))

    main = stages["1"]
    return {
        "name": "fused_stage",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_stage.cu",
        "replaces": "tpubody/models/pallas_resnet.py:167",
        "replaces_fn": "tpubody/models/pallas_resnet.py::_stage_kernel",
        "shape": {"B": B, "H": 56, "W": 56, "C_in": 64, "C_mid": 64,
                  "C_out": 256, "blocks": 3,
                  "stage": "1 (stage 2's tail under stages)"},
        "launches": launches["fused_stage"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "stages": stages,
    }


ALL_PHASES = ("lbs", "serve", "bench", "raster", "video", "oracle", "vtiming",
              "zbuffer", "reconstruct", "rtiming", "stage", "backbone")
EXTRA_PHASES = ("vprofile",)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    full = set(phases) == set(ALL_PHASES)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    from tpubody_torch import native

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    lib = native.build()
    log(f"  built {lib} in {time.perf_counter() - t0:.2f} s")
    for path in sorted(glob.glob(os.path.join(os.path.dirname(lib), "*.log"))):
        with open(path) as f:     # nvcc -Xptxas -v: registers, spills
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  " + line.strip())
    native.library()

    kernels = []
    if "lbs" in phases:
        log("phase 2: fused_lbs vs its plain version")
        body, main_err = phase_kernels(dev)
    if "serve" in phases:
        log("phase 3: main path through InferenceServer -> hmr_smpl_step")
        launches, _ = phase_serve(dev)
    if "bench" in phases:
        log("phase 4: throughput")
        phase_bench(dev)
    if "lbs" in phases and "serve" in phases:
        log("phase 5: fused_lbs timing")
        kernels.append(phase_timing(body, launches, main_err))

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if set(phases) & {"raster", "video", "oracle", "vtiming",
                          "vprofile"}:
            setup = VideoSetup(dev, workdir)
        raster_err = None
        if "raster" in phases:
            log("phase 6: fused_raster vs its plain version")
            raster_err = phase_raster_kernels(setup)
        if "video" in phases:
            log("phase 7: video path through animate_from_amass at "
                f"{VIDEO_SIZE}^2, {VIDEO_FRAMES} frames")
            video_res = phase_video(setup, workdir)
        if "oracle" in phases:
            log("phase 8: tiled renderer vs the fragment renderer")
            phase_oracle(setup)
        if "vtiming" in phases and "video" in phases:
            log("phase 9: video timing")
            kernels.append(phase_video_timing(setup, workdir, video_res,
                                              raster_err))
        if "vprofile" in phases:
            log("extra phase: profile of the video path")
            phase_video_profile(setup, workdir)
        if set(phases) & {"zbuffer", "reconstruct", "rtiming"}:
            recon = ReconSetup(dev, RECON_SIZE)
        zbuffer_diffs = None
        if "zbuffer" in phases:
            log("phase 10: zbuffer vs its plain version")
            zbuffer_diffs = phase_zbuffer(recon)
        if "reconstruct" in phases:
            log(f"phase 11: reconstruct path at {RECON_SIZE}^2, 6890 "
                f"vertices")
            recon_res = phase_reconstruct(recon, workdir)
        if "rtiming" in phases and "reconstruct" in phases:
            log("phase 12: reconstruct timing")
            entry, fused24 = phase_recon_timing(recon, workdir, recon_res,
                                                zbuffer_diffs)
            for k in kernels:
                if k["name"] == "fused_raster":
                    k["launches_reconstruct"] = \
                        recon_res["launches"]["fused_raster"]
                    k["body_map_passes"] = fused24
            kernels.append(entry)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    if "stage" in phases:
        log("phase 13: fused_stage vs its plain version")
        phase_stage(dev)
    if "backbone" in phases:
        log(f"phase 14: the fused stage on the full-width backbone, batch "
            f"{BACKBONE_BATCH}")
        kernels.append(phase_backbone(dev))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if not full:
        log(f"phases {phases} passed on {smi} (subset: no result line)")
        return 0
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
