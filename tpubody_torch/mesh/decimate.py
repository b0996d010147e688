"""Mesh simplification by vertex clustering.

The reconstruction emits ~700k grid-mesh faces at 1024^2 — far denser than
needed for animation (the SMPL body is 13.8k faces).  Vertex clustering
snaps vertices to a voxel grid, welds each cell to its attribute-mean
vertex and drops degenerate faces: O(V) host work, topology-safe enough
for rendering/skinning, and it shrinks the rasterization load by the
decimation factor.  (The reference has no decimation — quality add.)

Numpy-only copy of ``tpubody.mesh.decimate``; ``decimate_avatar`` returns
the port's ``RiggedAvatar``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class DecimateResult(NamedTuple):
    points: np.ndarray   # (N', 3 + C) welded attribute rows
    faces: np.ndarray    # (F', 3)
    vertex_map: np.ndarray  # (N,) old vertex -> new vertex


def cluster_decimate(
    points: np.ndarray,      # (N, 3 + C) position + attributes
    faces: np.ndarray,       # (F, 3)
    cell_size: Optional[float] = None,
    target_verts: Optional[int] = None,
) -> DecimateResult:
    """Weld vertices within voxel cells; faces collapse where degenerate.

    Give either ``cell_size`` (world units) or ``target_verts`` (the cell
    size is then estimated from the bounding-box volume).
    """
    pts = np.asarray(points, np.float64)
    f = np.asarray(faces, np.int64)
    v = pts[:, :3]

    lo = v.min(axis=0)
    hi = v.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    if cell_size is None:
        if target_verts is None:
            raise ValueError("give cell_size or target_verts")
        # cells ~ target -> cell volume ~ bbox volume / target (occupied
        # cells are a 2D surface subset, so scale by a surface heuristic).
        area_cells = float(target_verts)
        cell_size = float(np.sqrt(extent[0] * extent[1] / area_cells) * 0.75)
        cell_size = max(cell_size, 1e-9)

    key = np.floor((v - lo) / cell_size).astype(np.int64)
    dims = key.max(axis=0) + 1
    code = (key[:, 0] * dims[1] + key[:, 1]) * dims[2] + key[:, 2]

    uniq, inverse = np.unique(code, return_inverse=True)
    n_new = uniq.shape[0]

    # Attribute mean per cell.
    sums = np.zeros((n_new, pts.shape[1]))
    np.add.at(sums, inverse, pts)
    counts = np.bincount(inverse, minlength=n_new)[:, None]
    new_points = sums / counts

    new_faces = inverse[f]
    # Drop faces that collapsed (any repeated corner).
    ok = ((new_faces[:, 0] != new_faces[:, 1])
          & (new_faces[:, 1] != new_faces[:, 2])
          & (new_faces[:, 0] != new_faces[:, 2]))
    new_faces = new_faces[ok]
    # Drop duplicate faces (same sorted corners).
    key2 = np.sort(new_faces, axis=1)
    _, first = np.unique(key2, axis=0, return_index=True)
    new_faces = new_faces[np.sort(first)]

    return DecimateResult(points=new_points, faces=new_faces,
                          vertex_map=inverse)


def decimate_avatar(avatar, target_verts: int = 25000):
    """Decimate a RiggedAvatar's template (weights re-normalized)."""
    from tpubody_torch.mesh import rigging
    pts = np.concatenate(
        [avatar.v_template, avatar.color, avatar.weights], axis=1)
    res = cluster_decimate(pts, avatar.faces, target_verts=target_verts)
    w = res.points[:, 6:6 + avatar.weights.shape[1]]
    w = np.maximum(w, 0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return rigging.RiggedAvatar(
        v_template=res.points[:, :3],
        weights=w,
        color=res.points[:, 3:6],
        faces=res.faces,
        joints=avatar.joints,
        parents=avatar.parents,
        or_pose=avatar.or_pose,
        or_shape=avatar.or_shape,
    )
