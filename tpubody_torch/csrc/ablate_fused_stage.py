#!/usr/bin/env python3
"""Where the fused_stage kernel's time goes: time builds of
``fused_stage.cu`` with one part taken out each, on one GPU.

    python3 tpubody_torch/csrc/ablate_fused_stage.py

There is no kernel profiler on every machine, so this is the coarse
substitute: the kernel's source carries inert ``#ifdef ABLATE_*`` hooks,
one shared library is built per variant with nvcc (all at once, each with
its macros defined), and each is timed with CUDA events at the five
stride-1 bottleneck shapes of the flagship backbone at batch 512.  A variant computes wrong values by design; only
its time is read.  Stages 3 and 4 (C_mid 256, 512) take the wide route:
one launch a bottleneck at stage 3, two at stage 4 (timed together).
Variants: the kernel as it is; the wide route in two launches everywhere
(h2 through device memory; this one computes the right values); no
tensor-core
products (wgmma); no A fragment loads (ldmatrix) either; no loads of x;
no loads of the weights (the ring still turns); no final epilogue
(residual read and store of y); each of the three convolutions alone;
and the weight ring at 3 and 4 stages (refused where the shared memory
does not hold it: printed as such).
Prints one line a (shape, variant) and one JSON object at the end.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.normpath(os.path.join(HERE, os.pardir, os.pardir, "build",
                                    "tpubody_torch", "ablate"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-shared"]

VARIANTS = {
    "as it is": [],
    "wide in two launches": ["ABLATE_WIDE_SPLIT"],
    "no mma": ["ABLATE_MMA"],
    "no mma, no ldmatrix": ["ABLATE_MMA", "ABLATE_FRAGMENTS"],
    "no x loads": ["ABLATE_X_LOADS"],
    "no weight loads": ["ABLATE_W_LOADS"],
    "no final epilogue": ["ABLATE_EPILOGUE"],
    "conv1 alone": ["ABLATE_CONV2", "ABLATE_CONV3"],
    "conv2 alone": ["ABLATE_CONV1", "ABLATE_CONV3"],
    "conv3 alone": ["ABLATE_CONV1", "ABLATE_CONV2"],
    "empty": ["ABLATE_CONV1", "ABLATE_CONV2", "ABLATE_CONV3"],
}
for _sw in (3, 4):
    VARIANTS[f"weight ring {_sw}"] = [f"ABLATE_SW={_sw}"]

# name, (B, H, W, C_in, C_mid, C_out), downsample
SHAPES = [
    ("stage 1 block 0: 64-64-256, 56^2, downsample", (512, 56, 56, 64, 64, 256), True),
    ("stage 1 blocks 1-2: 256-64-256, 56^2", (512, 56, 56, 256, 64, 256), False),
    ("stage 2 blocks 1-3: 512-128-512, 28^2", (512, 28, 28, 512, 128, 512), False),
    ("stage 3 blocks 1-5: 1024-256-1024, 14^2", (512, 14, 14, 1024, 256, 1024), False),
    ("stage 4 blocks 1-2: 2048-512-2048, 7^2", (512, 7, 7, 2048, 512, 2048), False),
]


def build() -> dict:
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(HERE, "fused_stage.cu")
    procs = {}
    for i, (name, defs) in enumerate(VARIANTS.items()):
        lib = os.path.join(OUT, f"variant_{i}.so")
        procs[name] = (lib, subprocess.Popen(
            ["nvcc", *NVCC_FLAGS, *[f"-D{d}" for d in defs], path, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        dll = ctypes.CDLL(lib)
        dll.tpubody_fused_stage_block.argtypes = \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        dll.tpubody_fused_stage_block.restype = ctypes.c_int
        libs[name] = dll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * 0.05).to(dtype).to(dev)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    results = {}
    for what, (B, H, W, cin, cmid, cout), down in SHAPES:
        x = rand(B, H, W, cin)
        y = torch.empty(B, H, W, cout, dtype=torch.bfloat16, device=dev)
        # h2 of the wide route (C_mid above 128: two launches a bottleneck)
        h2 = (torch.empty(B * H * W, -(-cmid // 64) * 64,
                          dtype=torch.bfloat16, device=dev)
              if cmid > 128 else None)
        # the packed, zero-padded sizes (models/fused_resnet.py _pack_block)
        pm, pi, po = (-(-c // 64) * 64 for c in (cmid, cin, cout))
        w = [rand(pm * pi), rand(pm, dtype=torch.float32),
             rand(9 * pm * pm), rand(pm, dtype=torch.float32),
             rand(po * pm), rand(po, dtype=torch.float32),
             rand(po * pi) if down else None,
             rand(po, dtype=torch.float32) if down else None]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        results[what] = {}
        for name, lib in libs.items():
            def call():
                err = lib.tpubody_fused_stage_block(
                    ptr(x), ptr(y), ptr(h2), *[ptr(t) for t in w], B, H, W,
                    cin, cmid, cout, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            try:
                call()
            except RuntimeError as e:
                print(f"{what:46s} {name:24s} refused: {e}", flush=True)
                results[what][name] = None
                continue
            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 10
            results[what][name] = ms
            print(f"{what:46s} {name:24s} {ms:8.3f} ms", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"fused_stage_ablation_ms": results, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
