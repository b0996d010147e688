"""ASF/AMC (CMU-mocap style) skeleton parsing, FK and SMPL retargeting.

Numpy-only copy of ``tpubody.io.asf`` over the port's
``io.motion.MotionClip`` (the port imports nothing of ``tpubody``); both
packages read the same files into the same clips.

Capability parity with the reference's ASF joint tree
(utils/skeleton.py:88-158: per-bone local frames ``C``, Euler-dof motion,
recursive ``set_motion``) and its ASF<->SMPL name maps
(utils/skeleton.py:32-86).  The reference ships only the consuming class;
this module additionally parses the standard ``.asf``/``.amc`` text formats
so CMU mocap clips drive the animation pipeline directly.

Parsing and the (tiny, ~30-bone) kinematic chain run on the host, with
all per-frame math vectorized over the full clip — Euler angles for every
(frame, bone) convert to rotation matrices in one shot and the FK chain is
a single pass over bones operating on (F, 3, 3) arrays.  The output is a
``MotionClip`` of SMPL axis-angle poses, which the batched skinning and
rendering path consumes like any AMASS clip.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpubody_torch.io.motion import MotionClip

# ASF bone name -> SMPL joint index (reference utils/skeleton.py:61-86).
ASF_SMPL_MAP: Dict[str, int] = {
    "root": 0, "lfemur": 1, "rfemur": 2, "upperback": 3, "ltibia": 4,
    "rtibia": 5, "thorax": 6, "lfoot": 7, "rfoot": 8, "lowerneck": 9,
    "ltoes": 10, "rtoes": 11, "upperneck": 12, "lclavicle": 13,
    "rclavicle": 14, "head": 15, "lhumerus": 16, "rhumerus": 17,
    "lradius": 18, "rradius": 19, "lwrist": 20, "rwrist": 21,
    "lhand": 22, "rhand": 23,
}

# SMPL joint index -> semantic name (reference utils/skeleton.py:5-30).
SMPL_KEYPOINT_SEMANTIC: Dict[int, str] = {
    0: "root", 1: "llegroot", 2: "rlegroot", 3: "lowerback", 4: "lknee",
    5: "rknee", 6: "upperback", 7: "lankle", 8: "rankle", 9: "thorax",
    10: "ltoes", 11: "rtoes", 12: "lowerneck", 13: "lclavicle",
    14: "rclavicle", 15: "upperneck", 16: "larmroot", 17: "rarmroot",
    18: "lelbow", 19: "relbow", 20: "lwrist", 21: "rwrist",
    22: "lhand", 23: "rhand",
}

# CMU ASF length unit -> meters: data is in inches scaled by 0.45
# (the reference divides joints by 0.45 when pairing skeletons,
# utils/skeleton.py:226-229; 2.54/100 converts inches to meters).
CMU_LENGTH_SCALE = (1.0 / 0.45) * 2.54 / 100.0


@dataclasses.dataclass
class ASFBone:
    name: str
    direction: np.ndarray          # (3,) unit vector, global frame
    length: float
    C: np.ndarray                  # (3, 3) local-axis frame
    Cinv: np.ndarray
    dof: Tuple[str, ...]           # subset of ("rx", "ry", "rz")
    limits: np.ndarray             # (3, 2) per-axis limits (deg), 0s if fixed
    parent: int = -1               # index into ASFSkeleton.bones


@dataclasses.dataclass
class ASFSkeleton:
    bones: List[ASFBone]           # bones[0] is root, topologically ordered
    name_to_index: Dict[str, int]
    length_scale: float = CMU_LENGTH_SCALE
    # Channel order of the root's AMC values (":root order" line).
    root_order: Tuple[str, ...] = ("tx", "ty", "tz", "rx", "ry", "rz")

    def index(self, name: str) -> int:
        return self.name_to_index[name]


def _euler_xyz_static(angles: np.ndarray) -> np.ndarray:
    """Static-xyz Euler angles (..., 3) -> rotation matrices (..., 3, 3):
    R = Rz(az) @ Ry(ay) @ Rx(ax) — transforms3d's default 'sxyz' convention
    used by the reference (utils/skeleton.py:94,117,128)."""
    angles = np.asarray(angles, np.float64)
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    R = np.empty(angles.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def _tokenize_sections(text: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    current: Optional[str] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith(":"):
            current = line[1:].split()[0].lower()
            sections[current] = []
            rest = line[1:].split(None, 1)
            if len(rest) > 1:
                sections[current].append(rest[1])
        elif current is not None:
            sections[current].append(line)
    return sections


def parse_asf(text: str) -> ASFSkeleton:
    """Parse an ASF skeleton definition (``:units``, ``:root``,
    ``:bonedata``, ``:hierarchy``)."""
    sections = _tokenize_sections(text)

    deg = True
    for line in sections.get("units", []):
        parts = line.split()
        if parts and parts[0] == "angle":
            deg = parts[1].lower().startswith("deg")

    def to_rad(v: np.ndarray) -> np.ndarray:
        return np.deg2rad(v) if deg else v

    root_axis = np.zeros(3)
    root_order: Tuple[str, ...] = ("tx", "ty", "tz", "rx", "ry", "rz")
    for line in sections.get("root", []):
        parts = line.split()
        if parts[0] == "axis":
            # e.g. "axis XYZ" — rotation application order; only XYZ
            # (the CMU convention) is supported.
            pass
        elif parts[0] == "order":
            root_order = tuple(p.lower() for p in parts[1:])
        elif parts[0] == "orientation":
            root_axis = np.asarray([float(x) for x in parts[1:4]])

    C_root = _euler_xyz_static(to_rad(root_axis))
    bones: List[ASFBone] = [ASFBone(
        name="root", direction=np.zeros(3), length=0.0, C=C_root,
        Cinv=np.linalg.inv(C_root), dof=("rx", "ry", "rz"),
        limits=np.zeros((3, 2)), parent=-1)]
    name_to_index = {"root": 0}

    # bonedata: begin/end blocks.
    block: List[str] = []
    blocks: List[List[str]] = []
    for line in sections.get("bonedata", []):
        if line == "begin":
            block = []
        elif line == "end":
            blocks.append(block)
        else:
            block.append(line)

    for blk in blocks:
        name = ""
        direction = np.zeros(3)
        length = 0.0
        axis = np.zeros(3)
        dof: Tuple[str, ...] = ()
        limit_vals: List[Tuple[float, float]] = []
        i = 0
        while i < len(blk):
            parts = blk[i].split()
            key = parts[0]
            if key == "name":
                name = parts[1]
            elif key == "direction":
                direction = np.asarray([float(x) for x in parts[1:4]])
            elif key == "length":
                length = float(parts[1])
            elif key == "axis":
                axis = np.asarray([float(x) for x in parts[1:4]])
            elif key == "dof":
                dof = tuple(p.lower() for p in parts[1:])
            elif key == "limits":
                # one "(lo hi)" pair per dof, possibly over several lines
                buf = blk[i][len("limits"):]
                while len(re.findall(r"\(", buf)) < len(dof) and i + 1 < len(blk):
                    i += 1
                    buf += " " + blk[i]
                for lo, hi in re.findall(
                        r"\(\s*([-\d.eE+]+)\s+([-\d.eE+]+)\s*\)", buf):
                    limit_vals.append((float(lo), float(hi)))
            i += 1
        C = _euler_xyz_static(to_rad(axis))
        limits = np.zeros((3, 2))
        for d, lv in zip(dof, limit_vals):
            axis_idx = {"rx": 0, "ry": 1, "rz": 2}[d]
            limits[axis_idx] = lv
        name_to_index[name] = len(bones)
        bones.append(ASFBone(
            name=name, direction=direction, length=length, C=C,
            Cinv=np.linalg.inv(C), dof=dof, limits=limits))

    # hierarchy: "parent child1 child2 ..." lines between begin/end.
    for line in sections.get("hierarchy", []):
        if line in ("begin", "end"):
            continue
        parts = line.split()
        parent = name_to_index[parts[0]]
        for child in parts[1:]:
            bones[name_to_index[child]].parent = parent

    # Re-order topologically (parents before children) so FK is one pass.
    order: List[int] = [0]
    added = {0}
    while len(order) < len(bones):
        grew = False
        for i, b in enumerate(bones):
            if i not in added and b.parent in added:
                order.append(i)
                added.add(i)
                grew = True
        if not grew:
            orphans = [b.name for i, b in enumerate(bones) if i not in added]
            raise ValueError(
                f"ASF :hierarchy never attaches bones {orphans} to the "
                "root (malformed file?)")
    remap = {old: new for new, old in enumerate(order)}
    bones = [bones[i] for i in order]
    for b in bones:
        b.parent = remap[b.parent] if b.parent >= 0 else -1
    name_to_index = {b.name: i for i, b in enumerate(bones)}
    bad = [ch for ch in root_order
           if ch not in ("tx", "ty", "tz", "rx", "ry", "rz")]
    if bad:
        raise ValueError(f"unsupported :root order channels {bad}")
    return ASFSkeleton(bones=bones, name_to_index=name_to_index,
                       root_order=root_order)


class AMCMotion(list):
    """Per-frame ``{bone: values}`` dicts plus the file's angle unit.

    A plain ``list`` subclass so existing callers that treat the result as
    a frame sequence keep working; ``degrees`` records the ``:degrees`` /
    ``:radians`` header so FK honors the declared unit."""

    def __init__(self, frames=(), degrees: bool = True):
        super().__init__(frames)
        self.degrees = degrees


def parse_amc(text: str, degrees: Optional[bool] = None) -> AMCMotion:
    """Parse an AMC motion file into per-frame {bone: values} dicts
    (the ``motion`` argument of the reference's ``Joint.set_motion``,
    utils/skeleton.py:112-132).  ``degrees=None`` reads the unit from the
    file header (``:degrees`` default)."""
    frames: List[Dict[str, np.ndarray]] = []
    cur: Optional[Dict[str, np.ndarray]] = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith(":"):
            flag = line[1:].lower()
            if degrees is None and flag.startswith("degrees"):
                degrees = True
            elif degrees is None and flag.startswith("radians"):
                degrees = False
            continue
        parts = line.split()
        if len(parts) == 1 and parts[0].isdigit():
            cur = {}
            frames.append(cur)
        elif cur is not None:
            cur[parts[0]] = np.asarray([float(x) for x in parts[1:]])
    return AMCMotion(frames, degrees=True if degrees is None else degrees)


def _frame_angles(skel: ASFSkeleton,
                  frames: Sequence[Dict[str, np.ndarray]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack AMC frames into dense arrays: per-bone Euler angles
    (F, B, 3) in radians and root translation (F, 3).

    Root channels are assigned per the skeleton's ``:root order`` line and
    non-root channels per each bone's parsed ``dof`` tuple (a bone may
    declare dof without limits — legal ASF — so dof, not nonzero limits,
    is authoritative).  Angles convert from degrees only when the AMC
    declared degrees (AMCMotion.degrees)."""
    F, B = len(frames), len(skel.bones)
    angles = np.zeros((F, B, 3))
    root_t = np.zeros((F, 3))
    axis_of = {"rx": 0, "ry": 1, "rz": 2}
    for f, frame in enumerate(frames):
        for bi, bone in enumerate(skel.bones):
            vals = frame.get(bone.name)
            if vals is None:
                continue
            if bone.name == "root":
                for k, ch in enumerate(skel.root_order[:len(vals)]):
                    if ch[0] == "t":
                        root_t[f, "xyz".index(ch[1])] = vals[k]
                    else:
                        angles[f, bi, axis_of[ch]] = vals[k]
            else:
                for k, d in enumerate(bone.dof[:len(vals)]):
                    if d in axis_of:
                        angles[f, bi, axis_of[d]] = vals[k]
    if getattr(frames, "degrees", True):
        angles = np.deg2rad(angles)
    return angles, root_t


def fk(skel: ASFSkeleton, frames: Sequence[Dict[str, np.ndarray]]
       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward kinematics over a whole clip, vectorized over frames.

    Returns (coords (F, B, 3) in meters, global_R (F, B, 3, 3),
    relative_R (F, B, 3, 3)) with the reference's semantics
    (utils/skeleton.py:112-132):
      relative_R[b] = C_b @ euler(angles_b) @ C_b^-1
      global_R[b]   = global_R[parent] @ relative_R[b]
      coord[b]      = coord[parent] + length_b * global_R[b] @ direction_b
    """
    angles, root_t = _frame_angles(skel, frames)
    F, B = angles.shape[:2]
    eul = _euler_xyz_static(angles)                       # (F, B, 3, 3)
    C = np.stack([b.C for b in skel.bones])               # (B, 3, 3)
    Cinv = np.stack([b.Cinv for b in skel.bones])
    rel = np.einsum("bij,fbjk,bkl->fbil", C, eul, Cinv)   # (F, B, 3, 3)

    glob = np.empty_like(rel)
    coords = np.empty((F, B, 3))
    scale = skel.length_scale
    glob[:, 0] = rel[:, 0]
    coords[:, 0] = root_t * scale
    for bi in range(1, B):
        bone = skel.bones[bi]
        p = bone.parent
        glob[:, bi] = glob[:, p] @ rel[:, bi]
        offset = np.einsum("fij,j->fi", glob[:, bi],
                           bone.direction) * (bone.length * scale)
        coords[:, bi] = coords[:, p] + offset
    return coords, glob, rel


def _relative_to_axis_angle(rel: np.ndarray) -> np.ndarray:
    """Batched rotation-matrix -> axis-angle ((..., 3, 3) -> (..., 3));
    vectorized version of the reference's export_theta conversion."""
    tr = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    axis = np.stack([
        rel[..., 2, 1] - rel[..., 1, 2],
        rel[..., 0, 2] - rel[..., 2, 0],
        rel[..., 1, 0] - rel[..., 0, 1],
    ], axis=-1)
    sin = np.sin(theta)
    small = sin < 1e-8
    safe = np.where(small, 1.0, 2.0 * sin)
    aa = axis / safe[..., None] * theta[..., None]
    return np.where(small[..., None], 0.0, aa)


def retarget_to_smpl(skel: ASFSkeleton,
                     frames: Sequence[Dict[str, np.ndarray]],
                     fps: float = 120.0,
                     stride: int = 1,
                     name_map: Optional[Dict[str, int]] = None) -> MotionClip:
    """CMU mocap clip -> SMPL MotionClip.

    Each mapped ASF bone's parent-relative rotation becomes the SMPL
    joint's local axis-angle (the correspondence the reference's
    asf_smpl_map encodes, utils/skeleton.py:61-86); unmapped SMPL joints
    stay at identity.  Root translation is first-frame-normalized like the
    AMASS reader.
    """
    name_map = ASF_SMPL_MAP if name_map is None else name_map
    _, _, rel = fk(skel, frames)
    _, root_t = _frame_angles(skel, frames)
    F = rel.shape[0]
    poses = np.zeros((F, 24, 3))
    for name, smpl_idx in name_map.items():
        bi = skel.name_to_index.get(name)
        if bi is None:
            continue
        poses[:, smpl_idx] = _relative_to_axis_angle(rel[:, bi])
    trans = root_t * skel.length_scale
    trans = trans - trans[0]
    return MotionClip(poses=poses[::stride], trans=trans[::stride],
                      fps=float(fps))


def read_amc(asf_path: str, amc_path: str, fps: float = 120.0,
             stride: int = 1) -> MotionClip:
    """Read an ASF skeleton + AMC motion pair into an SMPL MotionClip."""
    with open(asf_path) as f:
        skel = parse_asf(f.read())
    with open(amc_path) as f:
        frames = parse_amc(f.read())
    return retarget_to_smpl(skel, frames, fps=fps, stride=stride)
