"""The native host-geometry helper: build, load and call it.

``tpubody_torch/csrc/geometry.cpp`` (a copy of ``tpubody``'s
``native/geometry.cpp``) holds five sequential host-side routines with a
plain C interface: Moore boundary tracing, the once-only edges of a
triangle mesh, the boundary-ring walk over them, the grid triangulation of
a depth map and the DP backtrack of the boundary match.  It is host code,
so ``g++`` (not ``nvcc``) compiles it at first use into
``build/tpubody_torch/``, under the same file lock as the CUDA kernels
(:func:`tpubody_torch.native.build_lock`), and ``ctypes`` loads it.  It
is rebuilt when the source's hash changes.  A failed build raises with
the compiler's output: there is no silent fall-back.

The Python implementations these routines replace stay beside their
callers as the plain versions (``*_reference``); only a caller that asks
for one by name runs it, as the tests do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from tpubody_torch import native

SOURCE = os.path.join(native.CSRC, "geometry.cpp")
LIB_NAME = "libtpubody_geometry.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the helper if its source changed; return the library's
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host-geometry helper "
                           "(csrc/geometry.cpp) is compiled on first use")
    want = source_hash()
    with native.build_lock() as build_dir:
        lib_path = os.path.join(build_dir, LIB_NAME)
        stamp = os.path.join(build_dir, "geometry.sha256")
        have = open(stamp).read().strip() if os.path.exists(stamp) else ""
        if have != want or not os.path.exists(lib_path):
            tmp = lib_path + f".tmp{os.getpid()}"
            res = subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stdout}")
            os.replace(tmp, lib_path)
            with open(stamp, "w") as f:
                f.write(want)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded helper (built on first call), with every entry point's
    argument and result types declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        i64 = ctypes.c_int64
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.trace_boundary.restype = i64
        lib.trace_boundary.argtypes = [p_u8, i64, i64, p_i64, i64]
        lib.boundary_ring_walk.restype = i64
        lib.boundary_ring_walk.argtypes = [p_i64, i64, p_i64, i64]
        lib.boundary_edges_from_faces.restype = i64
        lib.boundary_edges_from_faces.argtypes = [p_i64, i64, p_i64, i64]
        lib.dp_backtrack.restype = None
        lib.dp_backtrack.argtypes = [p_i64, i64, i64, i64, p_i64]
        lib.grid_mesh_build.restype = i64
        lib.grid_mesh_build.argtypes = [
            p_u8, p_f32, p_f32, p_f32, i64, i64, i64, i64,
            p_i64, i64, p_f32, i64, ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
    return _LIB


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Moore tracing of the first foreground region in scan order ->
    (N, 2) int64 (x, y); (0, 2) for an empty mask."""
    lib = library()
    m = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    H, W = m.shape
    cap = 8 * (H + W) + 64
    out = np.empty((cap, 2), np.int64)
    n = lib.trace_boundary(m, H, W, out.reshape(-1), cap)
    while n == -1:  # perimeter larger than the estimate
        cap *= 4
        out = np.empty((cap, 2), np.int64)
        n = lib.trace_boundary(m, H, W, out.reshape(-1), cap)
    return out[:n].copy()


def boundary_ring_walk(edges: np.ndarray) -> np.ndarray:
    """Ordered walk over boundary edges (E, 2) from ``edges[0, 0]``,
    taking at each vertex its first listed neighbour other than the one it
    came from, until it returns to the start or finds no way on."""
    e = np.ascontiguousarray(np.asarray(edges, np.int64))
    cap = e.shape[0] + 2
    out = np.empty(cap, np.int64)
    n = library().boundary_ring_walk(e.reshape(-1), e.shape[0], out, cap)
    if n < 0:
        raise RuntimeError("boundary_ring_walk: walk longer than its edges")
    return out[:n].copy()


def boundary_edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Once-only (boundary) edges of a triangle mesh: faces (F, 3) ->
    (B, 2) int64 (lo, hi) pairs in ascending order of lo * V + hi."""
    f = np.ascontiguousarray(np.asarray(faces, np.int64))
    if f.size == 0:
        return np.zeros((0, 2), np.int64)
    # Every edge could be once-only (a triangle soup).
    cap = 3 * f.shape[0]
    out = np.empty((cap, 2), np.int64)
    n = library().boundary_edges_from_faces(f.reshape(-1), f.shape[0],
                                            out.reshape(-1), cap)
    if n < 0:
        raise RuntimeError("boundary_edges_from_faces: capacity exceeded")
    return out[:n].copy()


def grid_mesh_build(mask: np.ndarray, depth: np.ndarray, color: np.ndarray,
                    weights: np.ndarray, is_back: bool
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid triangulation + attribute gather: mask (H, W) truthy, depth
    (H, W), color (H, W, 3), weights (H, W, K) -> (points (N, 6+K)
    float32, faces (F, 3) int64)."""
    m = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    H, W = m.shape
    d = np.ascontiguousarray(np.asarray(depth, np.float32))
    c = np.ascontiguousarray(np.asarray(color, np.float32))
    w = np.ascontiguousarray(np.asarray(weights, np.float32))
    if d.shape != (H, W) or c.shape != (H, W, 3) or w.shape[:2] != (H, W):
        raise ValueError(f"grid_mesh_build: mask {m.shape}, depth {d.shape}, "
                         f"color {c.shape}, weights {w.shape}")
    K = w.shape[2]
    faces_cap = 2 * max(H - 1, 0) * max(W - 1, 0)
    faces = np.empty((faces_cap, 3), np.int64)
    points = np.empty((H * W, 6 + K), np.float32)
    nv = ctypes.c_int64(0)
    nf = library().grid_mesh_build(
        m, d.reshape(-1), c.reshape(-1), w.reshape(-1), H, W, K,
        int(bool(is_back)), faces.reshape(-1), faces_cap,
        points.reshape(-1), H * W, ctypes.byref(nv))
    if nf < 0:
        raise RuntimeError("grid_mesh_build: capacity exceeded")
    return points[:nv.value].copy(), faces[:nf].copy()


def dp_backtrack(args: np.ndarray, j_final: int) -> np.ndarray:
    """DP backtrack over the (m-1, n) argmin table from the final row's
    argmin ``j_final`` -> the (m,) match."""
    a = np.ascontiguousarray(np.asarray(args, np.int64))
    m = a.shape[0] + 1
    out = np.empty(m, np.int64)
    library().dp_backtrack(a.reshape(-1), m, a.shape[1], int(j_final), out)
    return out
