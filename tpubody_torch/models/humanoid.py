"""Structured parametric humanoid stand-in body model (port of
``tpubody.models.humanoid``: the same numpy generator, bit-identical
float64 output for a seed; only :func:`humanoid` builds tensors).

The plain ``params.synthetic`` blob (random bone directions, scattered
point cloud, random triangulation) has valid SHAPES but meaningless
GEOMETRY: plane sections, boundary rings, silhouettes, and limb-ratio
camera heuristics all degenerate on it.  This module builds a humanoid
that is geometrically real while staying fully deterministic and
asset-free:

  * a canonical T-pose skeleton with the standard SMPL/SMPLH topology
    (``params.SMPL_PARENTS`` / ``SMPLH_PARENTS``),
  * a capsule (triangulated tube + end caps) per bone, so every limb is
    a closed 2-manifold — wrist plane sections produce clean rings, the
    silhouette is humanlike, divide_face partitions front/back sanely,
  * skinning weights from distance-to-bone-SEGMENTS (sharp softmax),
  * a joint regressor that reproduces the rest joints from vertices,
  * shape blendshapes with semantic axes (beta0 = overall scale,
    beta1 = girth) plus small noise modes.

Replaces the blob as the ``load_or_synthetic`` fallback wherever a whole
pipeline (reconstruct -> rig -> hand graft -> animate) needs a body that
behaves like one.  The reference relies on real (stripped) SMPL pickles
for the same role (models/smpl_np.py:123-158).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike
from tpubody_torch.models import params as params_lib

# Canonical T-pose joint table for the 24 SMPL body joints (x = subject
# left, y = up, z = forward; meters, rough adult proportions).
_SMPL_TPOSE = np.array([
    [0.00, 0.00, 0.00],     # 0  pelvis
    [0.09, -0.08, 0.00],    # 1  left hip
    [-0.09, -0.08, 0.00],   # 2  right hip
    [0.00, 0.12, -0.01],    # 3  spine1
    [0.10, -0.50, 0.00],    # 4  left knee
    [-0.10, -0.50, 0.00],   # 5  right knee
    [0.00, 0.24, 0.00],     # 6  spine2
    [0.10, -0.90, -0.03],   # 7  left ankle
    [-0.10, -0.90, -0.03],  # 8  right ankle
    [0.00, 0.32, 0.00],     # 9  spine3
    [0.11, -0.97, 0.10],    # 10 left foot
    [-0.11, -0.97, 0.10],   # 11 right foot
    [0.00, 0.42, 0.00],     # 12 neck
    [0.07, 0.38, 0.00],     # 13 left collar
    [-0.07, 0.38, 0.00],    # 14 right collar
    [0.00, 0.52, 0.02],     # 15 head
    [0.17, 0.38, 0.00],     # 16 left shoulder
    [-0.17, 0.38, 0.00],    # 17 right shoulder
    [0.43, 0.38, 0.00],     # 18 left elbow
    [-0.43, 0.38, 0.00],    # 19 right elbow
    [0.68, 0.38, 0.00],     # 20 left wrist
    [-0.68, 0.38, 0.00],    # 21 right wrist
    [0.76, 0.38, 0.00],     # 22 left hand
    [-0.76, 0.38, 0.00],    # 23 right hand
])

# Per-bone capsule radius (indexed by CHILD joint of the bone), body part
# aware: torso/head thick, limbs medium, forearms/feet thin.
_BONE_RADIUS = {
    1: 0.075, 2: 0.075,          # pelvis->hips
    3: 0.105, 6: 0.115, 9: 0.105,  # spine column
    4: 0.062, 5: 0.062,          # thighs
    7: 0.045, 8: 0.045,          # shins
    10: 0.035, 11: 0.035,        # feet
    12: 0.045, 15: 0.090,        # neck, head
    13: 0.055, 14: 0.055,        # collars
    16: 0.050, 17: 0.050,        # shoulders
    18: 0.042, 19: 0.042,        # upper arms
    20: 0.033, 21: 0.033,        # forearms
    22: 0.028, 23: 0.028,        # hands
}
_FINGER_RADIUS = 0.009


def tpose_joints(n_joints: int = 24) -> np.ndarray:
    """(J, 3) canonical T-pose joint positions (24 = SMPL; 52 = SMPLH:
    the 22 shared body joints + 2x15 procedurally placed finger joints;
    55 = SMPL-X: SMPLH's layout plus jaw/left-eye/right-eye under the
    head)."""
    if n_joints == 24:
        return _SMPL_TPOSE.copy()
    if n_joints not in (52, 55):
        raise ValueError(
            f"humanoid supports 24, 52 or 55 joints, got {n_joints}")
    J = np.zeros((n_joints, 3))
    J[:22] = _SMPL_TPOSE[:22]
    hand_base = {"l": 22, "r": 37}
    if n_joints == 55:
        head = _SMPL_TPOSE[15]
        J[22] = head + np.array([0.00, -0.02, 0.075])   # jaw
        J[23] = head + np.array([0.032, 0.035, 0.080])  # left eye
        J[24] = head + np.array([-0.032, 0.035, 0.080])  # right eye
        hand_base = {"l": 25, "r": 40}
    # Finger chains: index, middle, pinky, ring, thumb (the SMPLH/SMPL-X
    # kintree order, params.SMPLH_PARENTS / SMPLX_PARENTS); 3 joints each,
    # extending along +-x past the wrist with small z fan and y drop.
    finger_z = {"index": 0.030, "middle": 0.010, "pinky": -0.030,
                "ring": -0.012, "thumb": 0.055}
    finger_y = {"index": 0.0, "middle": 0.0, "pinky": 0.0,
                "ring": 0.0, "thumb": -0.02}
    order = ("index", "middle", "pinky", "ring", "thumb")
    for side, wrist in (("l", 20), ("r", 21)):
        sx = 1.0 if side == "l" else -1.0
        base = hand_base[side]
        for fi, name in enumerate(order):
            for k in range(3):
                idx = base + 3 * fi + k
                reach = 0.045 + 0.028 * (k + 1)
                J[idx] = J[wrist] + np.array([
                    sx * reach, finger_y[name], finger_z[name]])
    return J


def _frame(axis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors orthogonal to ``axis``."""
    a = axis / (np.linalg.norm(axis) + 1e-12)
    ref = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else \
        np.array([1.0, 0.0, 0.0])
    u = np.cross(a, ref)
    u /= np.linalg.norm(u) + 1e-12
    v = np.cross(a, u)
    return u, v


def _capsule(p0: np.ndarray, p1: np.ndarray, radius: float,
             n_seg: int, n_rings: int) -> Tuple[np.ndarray, np.ndarray]:
    """Closed triangulated tube from p0 to p1: ``n_rings`` cross-section
    rings of ``n_seg`` vertices plus two cap apexes.  Every edge is shared
    by exactly two faces (a closed 2-manifold)."""
    axis = p1 - p0
    u, v = _frame(axis)
    ts = np.linspace(0.0, 1.0, n_rings)
    ang = np.linspace(0.0, 2 * np.pi, n_seg, endpoint=False)
    ring_dirs = np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v
    verts = []
    for t in ts:
        c = p0 + t * axis
        verts.append(c + radius * ring_dirs)
    verts = np.concatenate(verts, axis=0)
    a = axis / (np.linalg.norm(axis) + 1e-12)
    cap0 = p0 - radius * a
    cap1 = p1 + radius * a
    verts = np.concatenate([verts, cap0[None], cap1[None]], axis=0)
    i_cap0 = n_rings * n_seg
    i_cap1 = i_cap0 + 1

    faces = []
    for r in range(n_rings - 1):
        for s in range(n_seg):
            s2 = (s + 1) % n_seg
            a00 = r * n_seg + s
            a01 = r * n_seg + s2
            a10 = (r + 1) * n_seg + s
            a11 = (r + 1) * n_seg + s2
            faces.append((a00, a01, a10))
            faces.append((a01, a11, a10))
    for s in range(n_seg):          # cap fans
        s2 = (s + 1) % n_seg
        faces.append((i_cap0, s2, s))
        last = (n_rings - 1) * n_seg
        faces.append((i_cap1, last + s, last + s2))
    faces = np.asarray(faces, np.int32)
    # Orient consistently OUTWARD (renderers split front/back and shade by
    # winding): flip any face whose normal points against the outward
    # direction from the capsule axis / cap centers.
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(axis=1)
    mid = (p0 + p1) / 2.0
    t = np.clip(((centroid - p0) @ (p1 - p0)) /
                (float((p1 - p0) @ (p1 - p0)) + 1e-12), 0.0, 1.0)
    on_axis = p0 + t[:, None] * (p1 - p0)[None]
    outward = centroid - on_axis
    near_cap = np.linalg.norm(centroid - mid, axis=1) > \
        np.linalg.norm(p1 - mid)
    outward[near_cap] = centroid[near_cap] - mid
    flip = np.einsum("ij,ij->i", fn, outward) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts, faces


def _seg_dist(points: np.ndarray, p0: np.ndarray, p1: np.ndarray
              ) -> np.ndarray:
    """Distance of each point to the segment p0-p1."""
    d = p1 - p0
    denom = float(d @ d) + 1e-12
    t = np.clip(((points - p0) @ d) / denom, 0.0, 1.0)
    proj = p0 + t[:, None] * d[None]
    return np.linalg.norm(points - proj, axis=1)


def humanoid_numpy(n_joints: int = 24, n_verts: Optional[int] = None,
                   n_betas: int = 10, seed: int = 0) -> dict:
    """Raw float64 humanoid model dict (same keys as
    params.synthetic_numpy).  ``n_verts``: exact output vertex count —
    capsule resolution is chosen to approach it from below and the
    remainder is padded with unreferenced copies of vertex 0 (harmless
    to LBS and to all face-driven geometry)."""
    parents = params_lib.parents_for(n_joints)
    joints = tpose_joints(n_joints)
    rng = np.random.default_rng(seed)

    bones = [(parents[i], i) for i in range(1, n_joints)]

    def _is_finger(c: int) -> bool:
        # SMPLH: everything past the 22 body joints is a finger chain
        # (joints 22..51; note 22/23 are the left index chain, NOT the
        # SMPL hand joints).  SMPL-X adds jaw/eyes at 22-24 before the
        # finger chains; its face nubs get finger-grade (tiny capsule)
        # resolution too.
        if n_joints == 52:
            return c >= 22
        if n_joints == 55:
            return c >= 22
        return False

    # Budget: per-bone verts = n_rings*n_seg + 2.  Scale n_seg to the
    # requested count (fingers stay at minimum resolution), then shrink
    # until the analytic total fits n_verts exactly-or-below.
    n_body_bones = sum(1 for _, c in bones if not _is_finger(c))
    n_finger_bones = len(bones) - n_body_bones
    target = n_verts if n_verts else 64 * n_body_bones
    finger_cost = n_finger_bones * (6 * 3 + 2)
    per_bone = max((target - finger_cost) // max(n_body_bones, 1), 20)
    n_seg = int(np.clip(np.sqrt(per_bone / 1.5), 6, 48))
    n_rings = max((per_bone - 2) // n_seg, 3)

    def _total(seg, rings):
        return n_body_bones * (rings * seg + 2) + finger_cost

    if n_verts is not None:
        while _total(n_seg, n_rings) > n_verts and n_rings > 3:
            n_rings -= 1
        while _total(n_seg, n_rings) > n_verts and n_seg > 6:
            n_seg -= 1
        if _total(n_seg, n_rings) > n_verts:
            raise ValueError(
                f"humanoid minimum resolution needs "
                f"{_total(6, 3)} verts; requested {n_verts}")

    all_v, all_f, owner_child = [], [], []
    ring_members = {j: [] for j in range(n_joints)}
    offset = 0
    for p, c in bones:
        if _is_finger(c):
            seg, rings, rad = 6, 3, _FINGER_RADIUS
        else:
            seg, rings = n_seg, n_rings
            rad = _BONE_RADIUS[c]
        v, f = _capsule(joints[p], joints[c], rad, seg, rings)
        # The capsule's first/last cross-section rings are centered
        # EXACTLY at the parent/child joints — remember them so the
        # joint regressor can be exact (uniform ring average = center).
        ring_members[p].extend(range(offset, offset + seg))
        ring_members[c].extend(range(offset + (rings - 1) * seg,
                                     offset + rings * seg))
        all_v.append(v)
        all_f.append(f + offset)
        owner_child.extend([c] * v.shape[0])
        offset += v.shape[0]
    v_template = np.concatenate(all_v, axis=0)
    faces = np.concatenate(all_f, axis=0).astype(np.int32)
    owner_child = np.asarray(owner_child)

    if n_verts is not None and v_template.shape[0] > n_verts:
        raise ValueError(
            f"humanoid minimum resolution needs {v_template.shape[0]} "
            f"verts; requested {n_verts}")

    # Pad to the exact requested count with unreferenced copies of vertex
    # 0 (exact shapes matter to callers like serving's n_verts contract).
    if n_verts is not None and v_template.shape[0] < n_verts:
        pad = n_verts - v_template.shape[0]
        v_template = np.concatenate(
            [v_template, np.repeat(v_template[:1], pad, axis=0)], axis=0)
        owner_child = np.concatenate(
            [owner_child, np.repeat(owner_child[:1], pad)])

    V = v_template.shape[0]

    # Skinning weights: sharp softmax over distance to each bone segment
    # (assigned to the bone's CHILD joint, like SMPL's convention of the
    # weights that deform with that joint's rotation).  The root gets the
    # pelvis->spine1 segment.
    seg_d = np.full((V, n_joints), 1e3)
    for p, c in bones:
        seg_d[:, c] = np.minimum(seg_d[:, c],
                                 _seg_dist(v_template, joints[p], joints[c]))
    seg_d[:, 0] = _seg_dist(v_template, joints[0],
                            (joints[0] + joints[3]) / 2.0)
    logits = -seg_d / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    weights = np.exp(logits)
    weights /= weights.sum(axis=1, keepdims=True)

    # Joint regressor: uniform average over the capsule end rings
    # centered at each joint — EXACT (J_regressor @ v_template == joints
    # to fp precision), the property the real SMPL regressor has on its
    # template.
    j_regressor = np.zeros((n_joints, V))
    for j in range(n_joints):
        idx = np.asarray(ring_members[j], np.int64)
        j_regressor[j, idx] = 1.0 / idx.shape[0]

    # Shape blendshapes: beta0 = uniform scale about the pelvis,
    # beta1 = girth (inflate away from the owning bone axis), the rest
    # small smooth noise.
    shapedirs = rng.normal(scale=0.002, size=(V, 3, n_betas))
    shapedirs[:, :, 0] = 0.1 * (v_template - joints[0])
    radial = np.zeros((V, 3))
    for p, c in bones:
        sel = owner_child == c
        if not sel.any():
            continue
        d = joints[c] - joints[p]
        dn = d / (np.linalg.norm(d) + 1e-12)
        rel = v_template[sel] - joints[p]
        along = rel @ dn
        radial[sel] = rel - along[:, None] * dn[None]
    shapedirs[:, :, 1] = 0.3 * radial

    posedirs = rng.normal(scale=1e-4, size=(V, 3, 9 * (n_joints - 1)))

    out = dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        weights=weights,
        parents=tuple(parents),
        faces=faces,
    )
    if n_joints == 55:
        # SMPL-X face surface: expression modes that deform the head
        # capsule (jaw open = mode 0 pulls jaw-owned verts down/forward),
        # plus the synthetic barycentric face-landmark embedding on the
        # front of the head.
        expr_dirs = rng.normal(scale=1e-3, size=(V, 3, 10))
        head_sel = np.isin(owner_child, (15, 22, 23, 24))
        expr_dirs[~head_sel] *= 0.05
        jaw_sel = owner_child == 22
        expr_dirs[jaw_sel, :, 0] = np.array([0.0, -0.02, 0.01])
        out["expr_dirs"] = expr_dirs
        idx, bary = params_lib.face_landmark_embedding(
            v_template, faces, joints[15], jaw_center=joints[22])
        out["lmk_faces_idx"] = idx
        out["lmk_bary_coords"] = bary
    return out


def humanoid(n_joints: int = 24, n_verts: Optional[int] = None,
             n_betas: int = 10, seed: int = 0, dtype=torch.float32,
             device: DeviceLike = "cpu") -> params_lib.BodyModelParams:
    """BodyModelParams humanoid (see :func:`humanoid_numpy`)."""
    raw = humanoid_numpy(n_joints, n_verts, n_betas, seed)
    return params_lib.params_from_numpy(raw, dtype=dtype, device=device)
