"""Hand replacement: graft SMPL hands onto the reconstructed avatar (port
of ``tpubody.mesh.hands``: numpy on the host, the SMPL forward on the
model's device).

Capability parity with the reference Replace_Hands stage
(lib/Replace_Hands.py:666-920 + RecoverModel.replace_hands,
lib/mesh2smpl_model.py:209-224), re-designed on tpubody_torch.mesh primitives:

  1. cut both meshes at the wrists (attribute-carrying plane cuts,
     slicing.cut_faces_plane — the reference's custom slice_faces_plane),
  2. extract + angularly sort the wrist cross-section rings
     (slicing.section_ring replacing trimesh.section + Sort_verts),
  3. scale-match ring circumferences, offset inner rings along the forearm,
  4. translate the SMPL hands so their wrist rings meet the body's,
  5. loft a 4-ring B-spline surface bridge per wrist
     (mesh.bspline.loft_surface),
  6. stitch bridge bands to the nearest cut-boundary vertices on each side,
     blending color + skinning weights across the band,
  7. recolor the grafted hands from the body's wrist section and fix the
     hand-chain joints.

All performed in T-pose template space on the rigged avatar (as the
reference does on RecoverModel.v_template).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import sys

import numpy as np
import torch

from tpubody_torch.mesh import bspline, rigging, slicing
from tpubody_torch.models import smpl as smpl_lib

BAND_ROWS = 21   # delta_u = 0.05 in the reference -> 21 samples


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else np.zeros_like(v)


def _sort_ring(ring: np.ndarray, axis: np.ndarray) -> np.ndarray:
    """Order ring points by angle around ``axis`` (reference Sort_verts,
    lib/Replace_Hands.py:588-618)."""
    c = ring.mean(axis=0)
    axis = _unit(axis)
    # Plane basis.
    ref = np.array([1.0, 0, 0])
    if abs(np.dot(ref, axis)) > 0.9:
        ref = np.array([0, 1.0, 0])
    u = _unit(np.cross(axis, ref))
    v = np.cross(axis, u)
    d = ring - c
    ang = np.arctan2(d @ v, d @ u)
    return ring[np.argsort(ang)]


def _scale_ring(ring: np.ndarray, factor: float) -> np.ndarray:
    """Scale a ring about its centroid (out_bound2in_bound_{min,max}
    semantics: shrink or grow toward the target circumference)."""
    c = ring.mean(axis=0)
    return c + (ring - c) * factor


def _resample_ring(ring: np.ndarray, n: int, degree: int = 2) -> np.ndarray:
    """Closed-curve B-spline resampling to exactly n points
    (lib/Replace_Hands.py:778-808: append first point, fit, drop last)."""
    closed = np.vstack([ring, ring[:1]])
    out = bspline.fit_curve_points(closed.astype(np.float32), degree, n + 1)
    return out[:-1]


def _band_faces_and_points(
    surface_grid: np.ndarray,       # (rows, n, 3) bridge surface samples
    lower_idx: np.ndarray,          # (n,) indices into the full point list
    upper_idx: np.ndarray,          # (n,)
    lower_attrs: np.ndarray,        # (n, C) color+weights at the lower ring
    upper_attrs: np.ndarray,        # (n, C)
    base: int,                      # index offset for new band vertices
) -> Tuple[np.ndarray, np.ndarray]:
    """Stitch band between two matched boundaries through the surface's
    interior rows (reference verts2faces, lib/Replace_Hands.py:364-424)."""
    core = surface_grid[1:-1]
    rows, n = core.shape[:2]
    alpha = ((np.arange(rows) + 1) / (rows + 1))[:, None, None]
    attrs = lower_attrs[None] * (1 - alpha) + upper_attrs[None] * alpha
    pts = np.concatenate([core, attrs], axis=2).reshape(rows * n, -1)

    idx = np.arange(rows * n).reshape(rows, n) + base
    idx = np.concatenate([idx, idx[:, :1]], axis=1)
    low = np.concatenate([lower_idx, lower_idx[:1]])[None, :]
    up = np.concatenate([upper_idx, upper_idx[:1]])[None, :]
    stack = np.concatenate([low, idx, up], axis=0)

    p00 = stack[:-1, :-1].ravel()
    p10 = stack[1:, :-1].ravel()
    p11 = stack[1:, 1:].ravel()
    p01 = stack[:-1, 1:].ravel()
    faces = np.concatenate([
        np.stack([p00, p01, p10], axis=1),
        np.stack([p01, p11, p10], axis=1),
    ], axis=0)
    return faces, pts


def _pairwise_argmin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.sum(a ** 2, 1)[:, None] - 2 * a @ b.T + np.sum(b ** 2, 1)[None]
    return np.argmin(d, axis=1)


class HandGraftResult(NamedTuple):
    points: np.ndarray   # (N, 3 + C)
    faces: np.ndarray
    joints: np.ndarray   # (24, 3) updated


def replace_hands_mesh(
    body_points: np.ndarray,     # (N, 3+C) reconstructed mesh w/ attrs
    body_faces: np.ndarray,
    body_joints: np.ndarray,     # (24, 3)
    smpl_points: np.ndarray,     # (M, 3+C) SMPL template w/ attrs
    smpl_faces: np.ndarray,
    smpl_joints: np.ndarray,     # (24, 3)
) -> HandGraftResult:
    """Graft the SMPL mesh's hands onto the body mesh at the wrists."""
    J = body_joints.copy()
    C = body_points.shape[1]

    # Pull wrists inward (reference :667-669).
    diff = np.linalg.norm(J[20] - J[22]) / 8.0
    J[20] = J[20] - _unit(J[20] - J[18]) * diff * 3
    J[21] = J[21] - _unit(J[21] - J[19]) * diff * 3

    smpl_l_vec = _unit(smpl_joints[20] - smpl_joints[18])
    smpl_r_vec = _unit(smpl_joints[21] - smpl_joints[19])
    rec_l_vec = _unit(J[1] - J[2])     # across-body direction (:674-676)
    rec_r_vec = -rec_l_vec

    verts = body_points[:, :3]
    sverts = smpl_points[:, :3]

    out = {"points": None, "faces": None}
    sides = []
    for side, (rv, sv, wrist, elbow) in (
            ("l", (rec_l_vec, smpl_l_vec, 20, 18)),
            ("r", (rec_r_vec, smpl_r_vec, 21, 19))):
        # The reconstructed arm often ends short of the wrist joint (tips
        # erode through render/warp/depth) — slide the section plane
        # toward the elbow until it cuts a real ring instead of grazing
        # the arm tip.
        rec_ring = None
        cut_at = J[wrist]
        for t in (0.0, 0.15, 0.3, 0.45):
            cand = J[wrist] + t * (J[elbow] - J[wrist])
            ring = slicing.section_ring(verts, body_faces, cand, rv,
                                        near=cand)
            if ring.shape[0] >= 6:
                rec_ring, cut_at = ring, cand
                break
        smpl_ring = slicing.section_ring(sverts, smpl_faces,
                                         smpl_joints[wrist], sv,
                                         near=smpl_joints[wrist])
        if rec_ring is None or smpl_ring.shape[0] < 4:
            raise ValueError(f"wrist section failed on side {side}")
        J[wrist] = cut_at
        sides.append(dict(rv=rv, sv=sv, wrist=wrist, rec_ring=rec_ring,
                          smpl_ring=smpl_ring))

    # Cut: SMPL hands (positive side of forearm planes); body minus hands.
    smpl_l_cut = slicing.cut_faces_plane(
        smpl_points, smpl_faces, smpl_joints[20], smpl_l_vec)
    smpl_r_cut = slicing.cut_faces_plane(
        smpl_points, smpl_faces, smpl_joints[21], smpl_r_vec)
    body_cut1 = slicing.cut_faces_plane(
        body_points, body_faces, J[20], -rec_l_vec)
    body_cut = slicing.cut_faces_plane(
        body_cut1.points, body_cut1.faces, J[21], -rec_r_vec,
        track=body_cut1.boundary)
    l_bound = body_cut.tracked           # left-wrist cut boundary
    r_bound = body_cut.boundary
    for name, b in (("smpl left", smpl_l_cut.boundary),
                    ("smpl right", smpl_r_cut.boundary),
                    ("body left", l_bound), ("body right", r_bound)):
        if np.asarray(b).shape[0] < 3:
            # Degenerate geometry (e.g. nothing beyond the wrist plane):
            # bridging needs a cut boundary on both sides.
            raise ValueError(f"wrist cut produced no {name} boundary")

    body_pts = body_cut.points
    n_body = body_pts.shape[0]

    # Wrist ring colors from the body section -> recolor the SMPL hands
    # (reference get_hand_color :634-639, :878-887).
    ring_col_src = _pairwise_argmin(sides[0]["rec_ring"], verts)
    hand_color = body_points[ring_col_src, 3:6].mean(axis=0)

    out_points = [body_pts]
    out_faces = [body_cut.faces]
    offset = n_body
    new_joints = J.copy()

    for k, sd in enumerate(sides):
        cut = smpl_l_cut if k == 0 else smpl_r_cut
        bound = l_bound if k == 0 else r_bound
        hand_pts = cut.points.copy()
        if hand_pts.shape[1] < C:
            hand_pts = np.concatenate(
                [hand_pts, np.zeros((hand_pts.shape[0],
                                     C - hand_pts.shape[1]))], axis=1)

        rec_ring = sd["rec_ring"]
        smpl_ring = sd["smpl_ring"]
        rv, svec = sd["rv"], sd["sv"]
        wrist = sd["wrist"]

        # Circumference match (:692-709).
        lr = slicing.ring_length(rec_ring)
        ls = slicing.ring_length(smpl_ring)
        rec_in = _scale_ring(rec_ring, min(ls / max(lr, 1e-9), 1.0)
                             if lr > ls else max(ls / max(lr, 1e-9), 1.0))
        smpl_in = _scale_ring(smpl_ring, min(lr / max(ls, 1e-9), 1.0)
                              if ls > lr else max(lr / max(ls, 1e-9), 1.0))
        rec_in = rec_in + rv * diff          # offset inward (:712-722)
        smpl_in = smpl_in - svec * diff

        # Hand placement: wrist rings meet + forward offset (:737-745).
        translate = (rec_ring.mean(axis=0) - smpl_ring.mean(axis=0)
                     + svec * diff * 4)
        hand_pts[:, :3] += translate
        smpl_ring_t = smpl_ring + translate
        smpl_in_t = smpl_in + translate

        # Sort + equal-count resample of the 4 rings (:747-808).
        n = max(rec_ring.shape[0], 8)
        rings = []
        for ring in (rec_ring, rec_in, smpl_in_t, smpl_ring_t):
            r = _sort_ring(ring, svec)
            rings.append(_resample_ring(r, n))
        rings = np.stack(rings)  # (4, n, 3)

        # Loft bridge surface (:810-834).
        surf = bspline.loft_surface(rings.astype(np.float32),
                                    degree_u=3, degree_v=2)
        grid = bspline.eval_surface(surf, BAND_ROWS, n)

        # Match bridge boundary rows to cut boundaries (:848-861).
        body_match = bound[_pairwise_argmin(
            grid[0], body_pts[bound][:, :3])]
        hand_match = cut.boundary[_pairwise_argmin(
            grid[-1], cut.points[cut.boundary][:, :3])] + offset

        # Recolor hand.
        hand_pts[:, 3:6] = hand_color

        body_attrs = body_pts[body_match - 0][:, 3:]
        hand_attrs = hand_pts[hand_match - offset][:, 3:]

        out_points.append(hand_pts)
        out_faces.append(cut.faces + offset)
        offset += hand_pts.shape[0]

        band_faces, band_pts = _band_faces_and_points(
            grid, body_match, hand_match, body_attrs, hand_attrs, offset)
        out_points.append(band_pts)
        out_faces.append(band_faces)
        offset += band_pts.shape[0]

        # Updated joints (:908-914).
        new_joints[wrist] = rec_ring.mean(axis=0) + rv * diff * 2
        new_joints[22 + k] = smpl_joints[22 + k] + translate

    return HandGraftResult(
        points=np.concatenate(out_points, axis=0),
        faces=np.concatenate(out_faces, axis=0),
        joints=new_joints,
    )


def replace_hands(avatar: rigging.RiggedAvatar,
                  smpl_model,
                  strict: bool = False) -> rigging.RiggedAvatar:
    """RecoverModel.replace_hands parity (lib/mesh2smpl_model.py:209-224):
    graft SMPL hands onto the avatar's T-pose template.

    Degenerate wrist geometry (no section ring or no cut boundary — e.g.
    a reconstruction with fused or missing hands) cannot be bridged; by
    default the avatar is returned unchanged with a warning instead of
    crashing mid-pipeline (``strict=True`` re-raises).  The SMPL forward
    runs in float32 on the model's device."""
    dev = smpl_model.device
    state = smpl_lib.forward(
        smpl_model, torch.zeros((24, 3), device=dev),
        torch.as_tensor(np.asarray(avatar.or_shape, np.float32), device=dev))
    smpl_verts = state.verts.cpu().numpy().astype(np.float64)
    smpl_J = state.joints_rest.cpu().numpy().astype(np.float64)
    smpl_color = np.full_like(smpl_verts, 125.0)
    smpl_points = np.concatenate(
        [smpl_verts, smpl_color, smpl_model.weights.cpu().numpy()], axis=1)

    body_points = np.concatenate(
        [avatar.v_template, avatar.color, avatar.weights], axis=1)

    try:
        res = replace_hands_mesh(
            body_points, avatar.faces, avatar.joints,
            smpl_points, np.asarray(smpl_model.faces), smpl_J)
    except ValueError as exc:
        if strict:
            raise
        print(f"WARNING: hand replacement skipped ({exc}); "
              "keeping the original hands.", file=sys.stderr)
        return avatar

    w = res.points[:, 6:30]
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return rigging.RiggedAvatar(
        v_template=res.points[:, :3],
        weights=w,
        color=res.points[:, 3:6],
        faces=res.faces,
        joints=res.joints,
        parents=avatar.parents,
        or_pose=avatar.or_pose,
        or_shape=avatar.or_shape,
    )
