"""Mesh smoothing filters (replaces trimesh.smoothing; the port's own copy
of ``tpubody.mesh.smoothing``, numpy on the host).

The reference smooths the stitch band and replaced hands with trimesh's
Humphrey filter (lib/Depth2Mesh_Bspline.py:138, lib/Replace_Hands.py).
Implemented here as vectorized neighbor-mean updates over a CSR
adjacency: a gather + mean on the host (meshes here are small and
dynamic-shaped).
"""
from __future__ import annotations

import numpy as np

from tpubody_torch.mesh.grid_mesh import vertex_adjacency


def _neighbor_mean(verts: np.ndarray, indptr: np.ndarray,
                   indices: np.ndarray) -> np.ndarray:
    sums = np.zeros_like(verts)
    np.add.at(sums, np.repeat(np.arange(len(indptr) - 1),
                              np.diff(indptr)), verts[indices])
    deg = np.maximum(np.diff(indptr), 1)[:, None]
    return sums / deg


def humphrey(verts: np.ndarray, faces: np.ndarray, alpha: float = 0.1,
             beta: float = 0.5, iterations: int = 10) -> np.ndarray:
    """Humphrey's classes (HC) smoothing.

    Laplacian smoothing that pushes back toward the original shape so the
    mesh doesn't shrink: q = neighbor mean; b = q - (alpha*orig +
    (1-alpha)*p); p' = q - (beta*b + (1-beta)*neighbor_mean(b)).
    Matches trimesh.smoothing.filter_humphrey's defaults.
    """
    verts = np.asarray(verts, np.float64)
    orig = verts.copy()
    indptr, indices = vertex_adjacency(np.asarray(faces), verts.shape[0])
    p = verts.copy()
    for _ in range(iterations):
        q = p.copy()
        mean = _neighbor_mean(q, indptr, indices)
        b = mean - (alpha * orig + (1.0 - alpha) * q)
        bmean = _neighbor_mean(b, indptr, indices)
        p = mean - (beta * b + (1.0 - beta) * bmean)
    return p


def laplacian(verts: np.ndarray, faces: np.ndarray, lamb: float = 0.5,
              iterations: int = 10) -> np.ndarray:
    """Plain Laplacian smoothing (trimesh.filter_laplacian parity)."""
    verts = np.asarray(verts, np.float64)
    indptr, indices = vertex_adjacency(np.asarray(faces), verts.shape[0])
    p = verts.copy()
    for _ in range(iterations):
        mean = _neighbor_mean(p, indptr, indices)
        p = p + lamb * (mean - p)
    return p


def smooth_band_grid(band: np.ndarray, alpha: float = 0.1, beta: float = 0.5,
                     iterations: int = 10) -> np.ndarray:
    """Humphrey smoothing specialized to a cyclic band grid (rows x cols,
    columns wrap) — the stitch band's shape.  Pure shifts, no adjacency
    build; vectorized."""
    p = np.asarray(band, np.float64)
    orig = p.copy()

    def nmean(x):
        up = np.vstack([x[:1], x[:-1]])
        dn = np.vstack([x[1:], x[-1:]])
        lf = np.roll(x, 1, axis=1)
        rt = np.roll(x, -1, axis=1)
        return (up + dn + lf + rt) / 4.0

    for _ in range(iterations):
        mean = nmean(p)
        b = mean - (alpha * orig + (1.0 - alpha) * p)
        p = mean - (beta * b + (1.0 - beta) * nmean(b))
    return p
