"""Array-based FK skeleton for repose estimation (the port's own copy of
``tpubody.core.skeleton``, numpy only, float64 on the host).

Replaces the reference's object-graph joint trees (``Joints``/``SMPLJoints``
with recursive set_motion/update_coord, models/smpl_np.py:8-120,
utils/skeleton.py:161-234) with flat (24, ...) arrays + explicit tree
traversal order — the repose path runs once per avatar on host, so clarity
and testability matter more than speed here; the hot skinning path lives in
tpubody_torch.core.lbs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def _rodrigues_np(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k)
            + np.sin(theta) * K)


def _mat_to_axis_angle(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (host, exact)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(c)
    if theta < 1e-8:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # 180 degrees: axis from the symmetric part.
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs using off-diagonals
        if axis[0] > 0:
            axis[1] = np.sign(A[0, 1]) * abs(axis[1])
            axis[2] = np.sign(A[0, 2]) * abs(axis[2])
        return axis / max(np.linalg.norm(axis), 1e-12) * theta
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return axis * theta


@dataclasses.dataclass
class Skeleton:
    """FK state: global motion rotations + local align rotations per joint."""

    parents: Tuple[int, ...]
    rest_joints: np.ndarray                 # (J, 3)
    coords: np.ndarray = None               # (J, 3) current coordinates
    motion_R: np.ndarray = None             # (J, 3, 3) composed global motion
    align_R: np.ndarray = None              # (J, 3, 3) local align

    def __post_init__(self):
        J = len(self.parents)
        self.rest_joints = np.asarray(self.rest_joints, np.float64)
        if self.coords is None:
            self.coords = self.rest_joints.copy()
        if self.motion_R is None:
            self.motion_R = np.tile(np.eye(3), (J, 1, 1))
        if self.align_R is None:
            self.align_R = np.tile(np.eye(3), (J, 1, 1))
        self.to_parent = self.rest_joints.copy()
        for i in range(1, J):
            self.to_parent[i] = (self.rest_joints[i]
                                 - self.rest_joints[self.parents[i]])

    def children(self, i: int) -> List[int]:
        return [j for j in range(1, len(self.parents))
                if self.parents[j] == i]

    def subtree(self, i: int) -> List[int]:
        out = [i]
        stack = [i]
        while stack:
            cur = stack.pop()
            for c in self.children(cur):
                out.append(c)
                stack.append(c)
        return out

    def set_motion(self, local_R: np.ndarray) -> None:
        """Compose local rotations down the tree into global motion_R
        (reference set_motion_R, models/smpl_np.py:57-62)."""
        J = len(self.parents)
        self.motion_R[0] = local_R[0]
        for i in range(1, J):
            self.motion_R[i] = self.motion_R[self.parents[i]] @ local_R[i]

    def set_align_propagate(self, i: int, R: np.ndarray) -> None:
        """Right-multiply align_R of joint i AND its whole subtree
        (reference set_align_R, models/smpl_np.py:63-66)."""
        for j in self.subtree(i):
            self.align_R[j] = self.align_R[j] @ R

    def set_align_local(self, i: int, R: np.ndarray) -> None:
        """Set only joint i's align (the legs path in gen_re_pose,
        models/smpl_np.py:323)."""
        self.align_R[i] = R

    def update_coords(self) -> None:
        """coordinate[i] = coord[parent] + (motion_R@align_R)[parent] @
        to_parent[i] (reference update_coord, models/smpl_np.py:76-82)."""
        J = len(self.parents)
        for i in range(1, J):
            p = self.parents[i]
            absolute = self.motion_R[p] @ self.align_R[p]
            self.coords[i] = self.coords[p] + absolute @ self.to_parent[i]

    def bone_vector(self, i: int) -> np.ndarray:
        """Vector from joint i to its first child (the reference's
        joints[i].children[0].vector)."""
        cs = self.children(i)
        c = cs[0]
        return self.coords[c] - self.coords[i]

    def export_theta(self) -> np.ndarray:
        """Per-joint local axis-angle from the composed global rotations
        (reference export_theta, models/smpl_np.py:98-110)."""
        J = len(self.parents)
        out = np.zeros((J, 3))
        for i in range(J):
            G_i = self.motion_R[i] @ self.align_R[i]
            if self.parents[i] < 0 or i == 0:
                rel = G_i
            else:
                G_p = self.motion_R[self.parents[i]] @ self.align_R[self.parents[i]]
                rel = np.linalg.inv(G_p) @ G_i
            out[i] = _mat_to_axis_angle(rel)
        return out


def _align_rotation(from_vec: np.ndarray, to_vec: np.ndarray,
                    flip_axis: bool = False) -> np.ndarray:
    """Rotation taking ``from_vec`` toward ``to_vec`` (minimal-angle)."""
    a = from_vec / max(np.linalg.norm(from_vec), 1e-12)
    b = to_vec / max(np.linalg.norm(to_vec), 1e-12)
    w = np.cross(b, a) if flip_axis else np.cross(a, b)
    n = np.linalg.norm(w)
    if n < 1e-12:
        return np.eye(3)
    theta = np.arccos(np.clip(np.dot(a, b), -1.0, 1.0))
    return _rodrigues_np(w / n * theta)


# Joint groups of the reference repose heuristic
# (models/smpl_np.py:313-350): legs get local-only aligns, shoulders+arms
# get propagated aligns.
LEG_JOINTS = (1, 2, 4, 5)
ARM_JOINTS = (13, 14, 16, 17, 18, 19)


def estimate_repose(
    smpl_rest_joints: np.ndarray,   # (24, 3) zero-pose SMPL joints (shaped)
    aligned_joints: np.ndarray,     # (24, 3) reconstructed joints (aligned)
    pose: np.ndarray,               # (24, 3) fitted body pose
    parents: Sequence[int],
) -> np.ndarray:
    """Estimate the pose that carries the SMPL skeleton onto the
    reconstructed skeleton (reference gen_re_pose,
    models/smpl_np.py:285-351).

    The torso pose above the waist is zeroed, arm/leg bone directions are
    aligned limb-by-limb (z flattened for joints 13+ so the alignment works
    in the image plane), and the result is exported as per-joint axis-angle.
    """
    smpl_J = np.asarray(smpl_rest_joints, np.float64).copy()
    smpl_J[13:, 2] = 0.0
    target = np.asarray(aligned_joints, np.float64).copy()
    target[13:, 2] = 0.0

    pose = np.asarray(pose, np.float64).copy()
    pose[12:, :] = 0.0
    motion = np.stack([_rodrigues_np(p) for p in pose])

    sk = Skeleton(parents=tuple(parents), rest_joints=smpl_J)
    tgt = Skeleton(parents=tuple(parents), rest_joints=target)
    sk.set_motion(motion)
    sk.update_coords()

    for i in LEG_JOINTS:
        r = _align_rotation(sk.bone_vector(i), tgt.bone_vector(i))
        sk.set_align_local(i, r)
    for i in ARM_JOINTS:
        # Note the reference flips the cross-product order here
        # (models/smpl_np.py:330-335) — axis = cross(target, current).
        r = _align_rotation(sk.bone_vector(i), tgt.bone_vector(i),
                            flip_axis=True)
        sk.set_align_propagate(i, r)
        sk.update_coords()
    return sk.export_theta()
