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
  5. timing  — each kernel against its plain version, one PyTorch call
               computing the same contractions, and its bound.

It then prints the kernel line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  It needs one CUDA GPU and no network.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")

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
        f" ({res['step_ms']:.3f} ms/step); split ms {res['split_ms']}")
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
    return {"kernels": [entry]}


def main() -> int:
    import torch

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

    log("phase 2: kernels vs plain versions")
    body, main_err = phase_kernels(dev)

    log("phase 3: main path through InferenceServer -> hmr_smpl_step")
    launches, _ = phase_serve(dev)

    log("phase 4: throughput")
    phase_bench(dev)

    log("phase 5: kernel timing")
    line = phase_timing(body, launches, main_err)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
