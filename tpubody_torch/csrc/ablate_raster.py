#!/usr/bin/env python3
"""Where the two raster kernels' time goes: time builds of
``fused_raster.cu`` and ``zbuffer.cu`` with one part taken out each, and
each at both cluster sizes, on one GPU, at the main paths' shapes.

    python3 tpubody_torch/csrc/ablate_raster.py [--parent DIR]

There is no kernel profiler on every machine, so this is the coarse
substitute (as ``ablate_fused_stage.py`` is for the stage kernel): the
kernels' sources carry inert ``#ifdef ABLATE_*`` hooks, one shared library
is built per variant with nvcc (all at once, each with its macros defined),
and each is timed with CUDA events, back to back (L2 warm, as the kernel
rows of PERF.md).  A variant computes wrong values by design; only its time
is read.  Variants, each at clusters of 1 and 2 blocks a tile: the kernel
as it is; no warp rejection (every face is evaluated at every warp); no
evaluation (the rejection test and its ballot stay); no bulk copies (the
ring still turns, on whatever the shared memory holds, so more faces may
pass the rejection); no stores of the outputs; and all three of the last
taken out.  Inputs: the tables that chip_smoke.py's main paths bin, with
its own set-ups: the video's base pass (8 frames of the 64-frame clip at
1024^2, C = 3), the body maps at 1024^2 (C = 24 and 3) and the z-buffer's
all-faces, front and back passes.  ``--parent DIR`` also builds and times
the kernels of another checkout's ``csrc`` (for example the parent
commit's), whose entry points take no cluster size, in the same run.
Prints one line a (shape, variant) and one JSON object at the end.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.normpath(os.path.join(HERE, os.pardir, os.pardir))
OUT = os.path.join(ROOT, "build", "tpubody_torch", "ablate_raster")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-shared"]

VARIANTS = {
    "as it is": [],
    "no rejection": ["ABLATE_REJECT"],
    "no evaluation": ["ABLATE_EVAL"],
    "no copies": ["ABLATE_COPIES"],
    "no stores": ["ABLATE_EPILOGUE"],
    "no copies, evaluation, stores": ["ABLATE_COPIES", "ABLATE_EVAL",
                                      "ABLATE_EPILOGUE"],
}
CLUSTERS = (1, 2)
ITERS = 50


def build(parent=None) -> dict:
    """-> {(kernel, variant): ctypes library}, all compiled at once."""
    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for kernel in ("fused_raster", "zbuffer"):
        src = os.path.join(HERE, f"{kernel}.cu")
        for i, (name, defs) in enumerate(VARIANTS.items()):
            jobs.append((kernel, name, src, defs,
                         os.path.join(OUT, f"{kernel}_{i}.so")))
        if parent:
            jobs.append((kernel, "parent", os.path.join(parent, f"{kernel}.cu"),
                         [], os.path.join(OUT, f"{kernel}_parent.so")))
    procs = [(kernel, name, lib, subprocess.Popen(
        ["nvcc", *NVCC_FLAGS, *[f"-D{d}" for d in defs], src, "-o", lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for kernel, name, src, defs, lib in jobs]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for kernel, name, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name!r}:\n{log}")
        dll = ctypes.CDLL(lib)
        cluster = [] if name == "parent" else [ci]
        if kernel == "fused_raster":
            fn = dll.tpubody_fused_raster
            fn.argtypes = [vp] * 4 + [ci] * 7 + [cf] + cluster + [vp]
        else:
            fn = dll.tpubody_zbuffer
            fn.argtypes = [vp] * 3 + [ci] * 5 + [cf] + cluster + [vp]
        fn.restype = ci
        libs[(kernel, name)] = fn
    return libs


def histogram(per_tile: torch.Tensor) -> dict:
    """Chunks a tile: the largest, the 99th percentile, the share of empty
    tiles."""
    n = per_tile.reshape(-1).float()
    return {"max": int(n.max()), "p99": float(torch.quantile(n, 0.99)),
            "empty_share": float((n == 0).float().mean()),
            "tiles": int(n.numel()), "chunks": int(n.sum())}


def inputs(dev):
    """The main paths' tables, binned by the port as chip_smoke.py's phases
    9 and 12 bin them -> [(name, kernel, args builder, histogram)]."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from tpubody_torch.render import raster, tiled_raster as TR

    cases = []
    workdir = tempfile.mkdtemp(prefix="ablate_raster_")
    video = CS.VideoSetup(dev, workdir)
    H = W = CS.VIDEO_SIZE
    screen, attrs = video.screen_attrs(slice(0, 8), "gouraud")
    faces, sx, sy, tc = video.passes[0]
    table, cstarts, _, _, meta = TR._bin_fused(screen, faces, attrs, H, W,
                                               tc, sx, sy)
    cases.append(("video base pass, B=8, C=3", "fused_raster",
                  (table, cstarts, H, W, meta), cstarts))
    recon = CS.ReconSetup(dev, CS.RECON_SIZE)
    S = recon.size
    scene, passes = recon.scene()
    for name, faces, attrs in passes:
        sx, sy, nc, tc = CS.zbuffer_plan(scene, faces, S, S)
        ftab, fst, _, _, fmeta = TR._bin_fused(
            scene[None], faces, attrs[None].contiguous(), S, S, tc, sx, sy)
        cases.append((f"body maps {name}, C={attrs.shape[-1]}",
                      "fused_raster", (ftab, fst, S, S, fmeta), fst))
        ztab, nch, _ = TR.bin_faces(scene[None], faces, S, S, nc, sx, sy)
        fb = raster._face_bits(int(faces.shape[0]))
        cases.append((f"zbuffer {name}", "zbuffer",
                      (ztab, nch, S, S, {"fb": fb,
                                         "depth_levels": 1 << (31 - fb)}),
                      nch))
    return cases


def call(fn, kernel, cluster, args, outs, stream):
    table, index, H, W, meta = args
    zcap = ctypes.c_float(float(meta["depth_levels"] - 1))
    extra = [] if cluster is None else [cluster]
    if kernel == "fused_raster":
        B, MAXC, CF, G, _ = table.shape
        win, attr = outs
        return fn(table.data_ptr(), index.data_ptr(), win.data_ptr(),
                  attr.data_ptr(), B, H, W, MAXC, CF, G - 5, meta["fb"],
                  zcap, *extra, stream)
    B, _, NC = table.shape[:3]
    return fn(table.data_ptr(), index.data_ptr(), outs[0].data_ptr(), B, H,
              W, NC, meta["fb"], zcap, *extra, stream)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout's tpubody_torch/csrc to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build(args.parent)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    results = {}
    for what, kernel, kargs, index in inputs(dev):
        table, _, H, W, _ = kargs
        B = table.shape[0]
        if kernel == "fused_raster":
            outs = (torch.empty(B, H, W, dtype=torch.int32, device=dev),
                    torch.empty(B, table.shape[3] - 5, H, W, device=dev))
            per_tile = index[:, 1:] - index[:, :-1]
        else:
            outs = (torch.empty(B, H, W, dtype=torch.int32, device=dev),)
            per_tile = index
        results[what] = {"chunks_a_tile": histogram(per_tile)}
        print(f"{what:34s} chunks a tile: {results[what]['chunks_a_tile']}",
              flush=True)
        runs = []
        for (k, name), fn in libs.items():
            if k != kernel:
                continue
            if name == "parent":
                runs.append(("parent", fn, None))
            else:
                runs += [(f"{name}, cluster {c}", fn, c) for c in CLUSTERS]
        # twice, in turns, so that a drift of the card shows
        for label, fn, cluster in runs + runs[::-1]:
            def once():
                err = call(fn, kernel, cluster, kargs, outs, stream)
                if err:
                    raise RuntimeError(f"{what} {label}: CUDA error {err}")
            for _ in range(5):
                once()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                once()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / ITERS
            results[what].setdefault(label, []).append(ms)
            print(f"{what:34s} {label:32s} {ms:8.4f} ms", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"raster_ablation_ms": results, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
