"""Front/back depth-mesh stitching with a B-spline loft band (port of
``tpubody.mesh.stitch``: numpy on the host, the mask closing on the
caller's device).

Capability parity with the reference stitch stage
(lib/Depth2Mesh_Bspline.py:371-464 stich_mesh + verts2faces + recover_3d_J):

  1. grid-triangulate the front and back depth maps (grid_mesh),
  2. rotate the back mesh by the shoulder-line angle,
  3. align back depth to the front frame via boundary statistics,
  4. extract the ordered silhouette boundary ring + inner ring,
  5. loft a stitch band through 4 rings (front-inner, front-boundary
     midpoints, back-boundary midpoints, back-inner) with degree-2
     B-spline cross-curves — fitted batched in one vectorized solve
     (bspline.fit_curves_batch) instead of a python loop of geomdl objects,
  6. smooth the band (cyclic-grid Humphrey), blend color/weights from
     front to back along the band rows,
  7. emit band faces + the two rows of faces joining band to front/back,
  8. recover 3D arm-joint positions by plane-slicing the stitched mesh.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.image import morphology
from tpubody_torch.mesh import bspline, grid_mesh, slicing, smoothing


def _sub(timer, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext()


class StitchResult(NamedTuple):
    points: np.ndarray    # (N, 3 + C) stitched attribute mesh
    faces: np.ndarray     # (F, 3)
    joints3d: np.ndarray  # (24, 3) recovered 3D joints


def _close_mask(front_depth: np.ndarray, device: torch.device) -> np.ndarray:
    m = torch.as_tensor((front_depth > 0).astype(np.float32), device=device)
    return morphology.close(m, 3).cpu().numpy() > 0


def _midpoint_ring(ring_pts: np.ndarray) -> np.ndarray:
    """Midpoints between consecutive ring points (reference's *_inter rolls,
    lib/Depth2Mesh_Bspline.py:420-428)."""
    rolled = np.vstack([ring_pts[1:], ring_pts[-1:]])
    return (ring_pts + rolled) / 2.0


def stitch_mesh(
    front_depth: np.ndarray,   # (H, W)
    front_color: np.ndarray,   # (H, W, 3)
    back_depth: np.ndarray,
    back_color: np.ndarray,
    weights: np.ndarray,       # (H, W, K) skinning-weight map
    J_2d: np.ndarray,          # (24, 2) int pixel joints (x, y)
    band_rows: int = 11,
    timer=None,
    device: DeviceLike = "cuda",
) -> StitchResult:
    """Stitch the two depth meshes into one closed attribute mesh.  The
    silhouette's closing runs on ``device`` (the card unless the caller
    asks for the CPU); everything else on the host."""
    dev = resolve(device)
    with _sub(timer, "stitch/close_mask"):
        mask = _close_mask(front_depth, dev)
    J_2d = np.asarray(J_2d).astype(int)

    with _sub(timer, "stitch/depth_to_mesh"):
        angle = grid_mesh.back_rotation_angle(front_depth, back_depth, J_2d)
        front = grid_mesh.depth_to_mesh(front_depth, front_color, weights,
                                        mask, is_back=False)
        back = grid_mesh.depth_to_mesh(back_depth, back_color, weights, mask,
                                       is_back=True, rotate_y=angle)

    # Boundary rings (front and back grids share topology -> same indices).
    with _sub(timer, "stitch/rings"):
        ring = grid_mesh.boundary_ring(front.faces)
        inner = grid_mesh.inner_ring(front.faces, ring,
                                     front.points.shape[0])

    front_out = front.points[ring]
    front_in = front.points[inner]
    back_out = back.points[ring].copy()
    back_in = back.points[inner].copy()

    # Depth alignment (reference lib/Depth2Mesh_Bspline.py:393-404).
    front_bound_mean = front_out[:, 2].mean()
    back_bound_mean = back_out[:, 2].mean()
    bound_diff = front_bound_mean - back_bound_mean
    mesh_diff = front_bound_mean - front.points[:, 2].mean()
    diff = bound_diff + 1.5 * mesh_diff
    back_points = back.points.copy()
    back_points[:, 2] += diff
    back_out[:, 2] += diff
    back_in[:, 2] += diff

    # 3D joints: x, y from J_2d; z halfway between the two sheets
    # (lib/Depth2Mesh_Bspline.py:406-408).
    jz = (front_depth[J_2d[:, 1], J_2d[:, 0]]
          + back_depth[J_2d[:, 1], J_2d[:, 0]] + diff) / 2.0
    J_3d = np.concatenate([J_2d.astype(np.float64), jz[:, None]], axis=1)

    # Cross-curve control points: 4 rings -> (n, 4, 3).
    cross = np.stack([
        front_in[:, :3],
        _midpoint_ring(front_out[:, :3]),
        _midpoint_ring(back_out[:, :3]),
        back_in[:, :3],
    ], axis=1)

    bound_n = ring.shape[0]
    # Fit every 2nd cross-curve, evaluate band_rows samples along each —
    # one vectorized batched solve.
    with _sub(timer, "stitch/bspline_band"):
        band_half = np.asarray(bspline.fit_curves_batch(
            cross[::2].astype(np.float32), 2, band_rows))     # (n/2, rows, 3)
    band = np.swapaxes(band_half, 0, 1)                       # (rows, n/2, 3)

    # Upsample back to full ring resolution with midpoint smoothing
    # (lib/Depth2Mesh_Bspline.py:447-451).
    band_rep = np.repeat(band, 2, axis=1)
    band_roll = np.concatenate([band_rep[:, 1:], band_rep[:, -1:]], axis=1)
    band_full = ((band_rep + band_roll) / 2.0)[:, :bound_n]

    # Interior band rows only (first/last coincide with existing rings).
    band_core = band_full[1:-1]
    band_core = smoothing.smooth_band_grid(band_core)

    rows, cols = band_core.shape[:2]
    # Blend attributes (color + weights) front->back down the band.
    attr_f = front.points[inner][:, 3:]
    attr_b = back_points[inner][:, 3:]
    alpha = (np.arange(rows, dtype=np.float32) / rows)[:, None, None]
    band_attrs = attr_f[None] * (1 - alpha) + attr_b[None] * alpha
    band_points = np.concatenate(
        [band_core.reshape(rows * cols, 3).astype(np.float32),
         band_attrs.reshape(rows * cols, -1)], axis=1)

    n_front = front.points.shape[0]
    band_base = 2 * n_front

    # Band grid indices with cyclic wrap (cols + 1 columns).
    idx = np.arange(rows * cols).reshape(rows, cols)
    idx = np.concatenate([idx, idx[:, :1]], axis=1)
    ring_closed = np.concatenate([ring, ring[:1]])

    stack = np.concatenate([
        ring_closed[None, :],                    # front boundary ring
        idx + band_base,                         # band rows
        ring_closed[None, :] + n_front,          # back boundary ring
    ], axis=0)
    p00 = stack[:-1, :-1].ravel()
    p10 = stack[1:, :-1].ravel()
    p11 = stack[1:, 1:].ravel()
    p01 = stack[:-1, 1:].ravel()
    stitch_faces = np.concatenate([
        np.stack([p00, p01, p10], axis=1),
        np.stack([p01, p11, p10], axis=1),
    ], axis=0)

    with _sub(timer, "stitch/assemble"):
        full_points = np.concatenate(
            [front.points, back_points, band_points], axis=0)
        full_faces = np.concatenate(
            [front.faces, back.faces + n_front, stitch_faces], axis=0)

    with _sub(timer, "stitch/recover_joints"):
        joints = recover_joints(full_points[:, :3], full_faces, J_3d)
    return StitchResult(points=full_points, faces=full_faces, joints3d=joints)


def _unit(v: np.ndarray) -> Optional[np.ndarray]:
    n = np.linalg.norm(v)
    if n < 1e-12:
        return None
    return v / n


def recover_joints(verts: np.ndarray, faces: np.ndarray,
                   J_3d: np.ndarray) -> np.ndarray:
    """Recover arm-chain joint positions by plane slicing
    (reference recover_3d_J, lib/Depth2Mesh_Bspline.py:466-492).

    The mesh is restricted below the neck plane, split into left/right arm
    half-spaces along the shoulder line, and each elbow/wrist joint is moved
    to the centroid of the mesh cross-section at its position.
    """
    out = J_3d.copy()
    up = _unit(J_3d[3] - J_3d[0])          # spine direction
    diff = np.linalg.norm(J_3d[20] - J_3d[18]) / 2.0

    vm = slicing.halfspace_vertex_mask(verts, J_3d[23] - up * diff, up)
    body_faces = slicing.restrict_faces(faces, vm)

    l_vec = _unit(J_3d[1] - J_3d[2])       # toward left
    r_vec = _unit(J_3d[2] - J_3d[1])
    lm = slicing.halfspace_vertex_mask(verts, J_3d[16] + l_vec * diff * 0.3,
                                       l_vec)
    rm = slicing.halfspace_vertex_mask(verts, J_3d[17] + r_vec * diff * 0.3,
                                       r_vec)
    l_faces = slicing.restrict_faces(body_faces, lm)
    r_faces = slicing.restrict_faces(body_faces, rm)

    def compact(fs):
        # The arm half-spaces keep a small fraction of the stitched mesh;
        # sectioning against the compacted vertex set avoids re-scanning
        # all ~1M vertices per joint (measured hotspot at 1024^2).
        vid = np.unique(fs)
        remap = np.zeros(verts.shape[0], np.int64)
        remap[vid] = np.arange(vid.shape[0])
        return verts[vid], remap[fs]

    r_verts, r_fc = compact(r_faces)
    r_dir = _unit(J_3d[19] - J_3d[17])
    for index in (21, 23):                 # right elbow/wrist chain
        c = slicing.section_centroid(r_verts, r_fc, J_3d[index], r_dir)
        if c is not None:
            out[index] = c
    l_verts, l_fc = compact(l_faces)
    l_dir = _unit(J_3d[18] - J_3d[16])
    for index in (18, 20, 22):             # left chain
        c = slicing.section_centroid(l_verts, l_fc, J_3d[index], l_dir)
        if c is not None:
            out[index] = c
    return out
