#!/usr/bin/env python3
"""Where the fused_stage kernel's time goes: time builds of
``fused_stage.cu`` with one part taken out each, on one GPU.

    python3 tpubody_torch/csrc/ablate_fused_stage.py

There is no kernel profiler on every machine, so this is the coarse
substitute: the kernel's source carries inert ``#ifdef ABLATE_*`` hooks,
one shared library is built per variant with nvcc (all at once, each with
its macros defined), and each is timed with CUDA events at the three bottleneck shapes of the flagship
backbone at batch 512.  A variant computes wrong values by design; only
its time is read.  Variants: the kernel as it is; no tensor-core
products (mma); no fragment loads either; no loads of x; no loads of the
weights; no final epilogue (residual read and store of y); each of the
three convolutions alone; and each (K slice, ring depth) build forced.
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
    "no mma": ["ABLATE_MMA"],
    "no mma, no ldmatrix": ["ABLATE_FRAGMENTS"],
    "no x loads": ["ABLATE_X_LOADS"],
    "no weight loads": ["ABLATE_W_LOADS"],
    "no final epilogue": ["ABLATE_EPILOGUE"],
    "conv1 alone": ["ABLATE_CONV2", "ABLATE_CONV3"],
    "conv2 alone": ["ABLATE_CONV1", "ABLATE_CONV3"],
    "conv3 alone": ["ABLATE_CONV1", "ABLATE_CONV2"],
    "empty": ["ABLATE_CONV1", "ABLATE_CONV2", "ABLATE_CONV3"],
}
# A forced build is taken whether or not it leaves room for a second block
# on the SM: that shows what the second block is worth.
for _ks, _s in ((64, 2), (64, 3), (32, 2), (32, 3), (16, 4)):
    VARIANTS[f"K slice {_ks}, ring {_s}"] = [f"ABLATE_KS={_ks}",
                                              f"ABLATE_S={_s}"]

# name, (B, H, W, C_in, C_mid, C_out), downsample
SHAPES = [
    ("stage 1 block 0: 64-64-256, 56^2, downsample", (512, 56, 56, 64, 64, 256), True),
    ("stage 1 blocks 1-2: 256-64-256, 56^2", (512, 56, 56, 256, 64, 256), False),
    ("stage 2 blocks 1-3: 512-128-512, 28^2", (512, 28, 28, 512, 128, 512), False),
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
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
        w = [rand(cmid, cin), rand(cmid, dtype=torch.float32),
             rand(9, cmid, cmid), rand(cmid, dtype=torch.float32),
             rand(cout, cmid), rand(cout, dtype=torch.float32),
             rand(cout, cin) if down else None,
             rand(cout, dtype=torch.float32) if down else None]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        results[what] = {}
        for name, lib in libs.items():
            def call():
                err = lib.tpubody_fused_stage_block(
                    ptr(x), ptr(y), *[ptr(t) for t in w], B, H, W, cin, cmid,
                    cout, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            for _ in range(2):
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
