"""Build, load and count the port's hand-written CUDA kernels.

Every ``tpubody_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together), linked into
``build/tpubody_torch/libtpubody_torch_kernels.so`` and loaded with
``ctypes``.  The sources expose a plain C interface, so the build never
includes PyTorch's headers.  The library is rebuilt whenever the
sources' hash changes; nothing is compiled at import time.

Each kernel wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), os.pardir, "build",
                         "tpubody_torch")
LIB_NAME = "libtpubody_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Launch counts per kernel name, bumped by the wrappers.
LAUNCHES: Dict[str, int] = {"fused_lbs": 0, "fused_raster": 0, "zbuffer": 0,
                            "fused_stage": 0}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME); the port's CUDA "
                       "kernels are compiled on first use")


def _compile(out_path: str) -> None:
    nvcc = _nvcc()
    tmp = out_path + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, p in procs:
        log, _ = p.communicate()
        with open(os.path.join(tmp, os.path.basename(src) + ".log"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib_tmp = os.path.join(tmp, LIB_NAME)
    link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS, *objs, "-o", lib_tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    for log in glob.glob(os.path.join(tmp, "*.log")):
        os.replace(log, os.path.join(os.path.dirname(out_path),
                                     os.path.basename(log)))
    os.replace(lib_tmp, out_path)
    shutil.rmtree(tmp, ignore_errors=True)


def build() -> str:
    """Compile the kernel library if its sources changed; return its path.
    Safe against concurrent builders (file lock)."""
    build_dir = os.path.normpath(BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, LIB_NAME)
    stamp = os.path.join(build_dir, "sources.sha256")
    want = sources_hash()
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        have = open(stamp).read().strip() if os.path.exists(stamp) else ""
        if have != want or not os.path.exists(lib_path):
            _compile(lib_path)
            with open(stamp, "w") as f:
                f.write(want)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpubody_fused_lbs.argtypes = [vp, vp, vp, vp, vp, vp,
                                          ci, ci, ci, ci, ci, vp]
        lib.tpubody_fused_lbs.restype = ci
        lib.tpubody_fused_raster.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                             ci, ci, ci, ctypes.c_float, vp]
        lib.tpubody_fused_raster.restype = ci
        lib.tpubody_zbuffer.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                        ctypes.c_float, vp]
        lib.tpubody_zbuffer.restype = ci
        lib.tpubody_fused_stage_block.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.tpubody_fused_stage_block.restype = ci
        lib.tpubody_fused_stage_smem_bytes.argtypes = [ci, ci]
        lib.tpubody_fused_stage_smem_bytes.restype = ci
        lib.tpubody_cuda_error_string.argtypes = [ci]
        lib.tpubody_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().tpubody_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
