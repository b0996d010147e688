"""Build, load and count the port's hand-written CUDA kernels.

Every ``tpubody_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together), linked into
``build/tpubody_torch/libtpubody_torch_kernels.so`` and loaded with
``ctypes``.  The sources expose a plain C interface, so the build never
includes PyTorch's headers.  The library is rebuilt whenever the
sources' hash changes; nothing is compiled at import time.

Every kernel wrapper holds its tensors to the kernel's contract with
:func:`expect` and launches through :func:`launch`, which runs the entry
point on the device's current stream and counts the launch in
:data:`LAUNCHES`, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), os.pardir, "build",
                         "tpubody_torch")
LIB_NAME = "libtpubody_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Launch counts per kernel name, bumped by the wrappers.
LAUNCHES: Dict[str, int] = {"fused_lbs": 0, "fused_raster": 0, "zbuffer": 0,
                            "fused_stage": 0, "int8_requant": 0,
                            "add_layernorm": 0, "soft_argmax": 0}

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


@contextlib.contextmanager
def build_lock():
    """Hold the build directory's file lock -> the directory's path.  Every
    library the port builds (these kernels, and the host-geometry helper
    of :mod:`tpubody_torch.geometry`) is compiled under it, so concurrent
    first users (test workers) never load a half-written file."""
    build_dir = os.path.normpath(BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield build_dir


def build() -> str:
    """Compile the kernel library if its sources changed; return its path.
    Safe against concurrent builders (file lock)."""
    want = sources_hash()
    with build_lock() as build_dir:
        lib_path = os.path.join(build_dir, LIB_NAME)
        stamp = os.path.join(build_dir, "sources.sha256")
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
                                             ci, ci, ci, ctypes.c_float, ci,
                                             vp]
        lib.tpubody_fused_raster.restype = ci
        lib.tpubody_zbuffer.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                        ctypes.c_float, ci, vp]
        lib.tpubody_zbuffer.restype = ci
        lib.tpubody_fused_stage_block.argtypes = [vp] * 11 + [ci] * 6 + [vp]
        lib.tpubody_fused_stage_block.restype = ci
        lib.tpubody_fused_stage_smem_bytes.argtypes = [ci, ci, ci]
        lib.tpubody_fused_stage_smem_bytes.restype = ci
        lib.tpubody_fused_stage_launches.argtypes = [ci, ci, ci]
        lib.tpubody_fused_stage_launches.restype = ci
        lib.tpubody_int8_requant.argtypes = [vp] * 10 + [ci] * 3 + [vp]
        lib.tpubody_int8_requant.restype = ci
        lib.tpubody_add_layernorm.argtypes = [vp, vp, ci, vp, vp, vp,
                                              ctypes.c_float, vp, vp, ci, ci,
                                              ci, vp]
        lib.tpubody_add_layernorm.restype = ci
        lib.tpubody_soft_argmax_slices.argtypes = [ci] * 5 + [
            ctypes.POINTER(ci)]
        lib.tpubody_soft_argmax_slices.restype = ci
        lib.tpubody_soft_argmax.argtypes = [vp, vp, vp] + [ci] * 6 + [
            ctypes.c_float, vp]
        lib.tpubody_soft_argmax.restype = ci
        lib.tpubody_cuda_error_string.argtypes = [ci]
        lib.tpubody_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().tpubody_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class KernelInputError(ValueError, RuntimeError):
    """A tensor that a kernel's contract refuses.  It is both a ValueError
    and a RuntimeError, so a caller may catch either."""


def expect(name: str, t: torch.Tensor, shape: Sequence[int],
           dtype: Union[torch.dtype, Tuple[torch.dtype, ...]],
           device: torch.device, aligned: bool = False) -> None:
    """Hold the tensor ``t`` that a kernel reads or writes to its contract:
    on ``device``, of ``dtype`` (or of one of a tuple of dtypes), of
    ``shape``, contiguous and, if ``aligned``, at a 16-byte aligned
    address.  Raises :class:`KernelInputError` naming ``name``."""
    if t.device != device:
        raise KernelInputError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        want = f"one of {dtype}" if isinstance(dtype, tuple) else dtype
        raise KernelInputError(f"{name} has dtype {t.dtype}, expected {want}")
    if tuple(t.shape) != tuple(shape):
        raise KernelInputError(f"{name} has shape {tuple(t.shape)}, expected "
                               f"{tuple(shape)}")
    if not t.is_contiguous():
        raise KernelInputError(f"{name} is not contiguous")
    if aligned and t.data_ptr() % 16:
        raise KernelInputError(f"{name} is not 16-byte aligned")


def launch(name: str, entry: str, device: torch.device, *args,
           count: int = 1) -> None:
    """Call the library's entry point ``entry`` with ``args`` and, as its
    last argument, ``device``'s current stream, with ``device`` current;
    raise on the CUDA error it returns, and add ``count`` kernel launches
    to ``LAUNCHES[name]``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    check(err, f"{name} launch")
    LAUNCHES[name] += count
