"""Extra surface joints + OpenPose-ordered joint extraction (port of
``tpubody.fit.joints``).

The reference gets nose/eye/ear/toe/fingertip "joints" from fixed mesh
vertices via smplx's VertexJointSelector, then permutes with JointMapper
(lib/gen_smplh.py:73, data_parser.py:137-181).  This module reproduces that:
21 standard surface-vertex ids appended after the model joints gives the
73-joint SMPLH (76-joint SMPL-X) set the OpenPose mapping indexes into.
SMPL-X additionally appends barycentric face landmarks (static 51 + 17
jawline contour) after the surface joints (reference util.py:133-137
maps them with an arange from 76).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpubody_torch.fit import keypoints as kp_lib

# Standard SMPL/SMPLH surface-vertex ids for the extra joints, in the order
# they are appended after the model joints (nose..heels, then fingertips) —
# the public smplx vertex_ids table the reference relies on.
SMPLH_EXTRA_VERTEX_IDS = np.array([
    332,    # nose
    6260,   # right eye
    2800,   # left eye
    4071,   # right ear
    583,    # left ear
    3216, 3226, 3387,   # left big toe, small toe, heel
    6617, 6624, 6787,   # right big toe, small toe, heel
    2746, 2319, 2445, 2556, 2673,   # left thumb/index/middle/ring/pinky tip
    6191, 5782, 5905, 6016, 6133,   # right fingertips
], np.int64)

# Same table for the 10475-vertex SMPL-X topology (public smplx
# vertex_ids 'smplx' column), same append order.
SMPLX_EXTRA_VERTEX_IDS = np.array([
    9120,   # nose
    9929,   # right eye
    9448,   # left eye
    616,    # right ear
    6,      # left ear
    5770, 5780, 8846,   # left big toe, small toe, heel
    8463, 8474, 8635,   # right big toe, small toe, heel
    5361, 4933, 5058, 5169, 5286,   # left thumb/index/middle/ring/pinky tip
    8079, 7669, 7794, 7905, 8022,   # right fingertips
], np.int64)


def extra_vertex_ids(num_verts: int, n_joints: int = 52) -> np.ndarray:
    """The standard table for the real templates; clipped ids as a graceful
    fallback for synthetic test meshes.  SMPL (24 joints) has no
    fingertips — only the 11 nose/eye/ear/toe/heel extras apply."""
    if n_joints == 55:
        table = SMPLX_EXTRA_VERTEX_IDS
        full = 10475
    else:
        table = (SMPLH_EXTRA_VERTEX_IDS if n_joints == 52
                 else SMPLH_EXTRA_VERTEX_IDS[:11])
        full = 6890
    if num_verts >= full:
        return table
    return np.clip(table, 0, num_verts - 1)


def landmark_gather(model) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host-side setup for the barycentric face landmarks: resolve the
    model's (L,) face indices into (L, 3) vertex ids once, so the traced
    forward is a plain gather + weighted sum."""
    if model.lmk_faces_idx is None or model.lmk_bary_coords is None:
        return None
    vert_ids = np.asarray(model.faces, np.int64)[
        np.asarray(model.lmk_faces_idx, np.int64)]
    return vert_ids, np.asarray(model.lmk_bary_coords, np.float32)


_INDEX_CACHE: dict = {}


def _index(ids, device) -> torch.Tensor:
    """Index table on ``device``, copied there once: a host table copied
    to the card on every objective evaluation would stall the stream.
    Made outside inference mode, so autograd may save it later."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device)
    a = np.ascontiguousarray(ids, np.int64)
    key = (a.shape, a.tobytes(), str(device))
    t = _INDEX_CACHE.get(key)
    if t is None:
        if len(_INDEX_CACHE) > 256:
            _INDEX_CACHE.clear()
        with torch.inference_mode(False):
            t = _INDEX_CACHE[key] = torch.as_tensor(a, device=device)
    return t


def face_landmarks(verts: torch.Tensor,
                   lmk: Tuple[np.ndarray, np.ndarray]) -> torch.Tensor:
    """(..., L, 3) landmark points: barycentric combination of face
    vertices (the smplx vertices2landmarks math as one gather + einsum)."""
    vert_ids, bary = lmk
    tri = verts[..., _index(vert_ids, verts.device), :]  # (..., L, 3, 3)
    if not isinstance(bary, torch.Tensor):
        bary = torch.as_tensor(np.asarray(bary), dtype=verts.dtype)
    return torch.einsum("...lkc,lk->...lc", tri,
                        bary.to(device=verts.device, dtype=verts.dtype))


def openpose_joints(
    verts: torch.Tensor,      # (..., V, 3) posed vertices
    joints: torch.Tensor,     # (..., J, 3) posed model joints (24/52/55)
    use_hands: bool = True,
    vertex_ids: Optional[np.ndarray] = None,
    lmk: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    use_face: bool = False,
    use_face_contour: bool = False,
) -> torch.Tensor:
    """Joints in OpenPose order: (..., 67, 3) [body25, lhand21, rhand21]
    for SMPLH (or 25 rows with use_hands=False), 25 body rows for SMPL,
    67+51[+17] rows for SMPL-X with ``use_face`` (needs ``lmk`` from
    :func:`landmark_gather`)."""
    n_j = joints.shape[-2]
    if vertex_ids is None:
        vertex_ids = extra_vertex_ids(verts.shape[-2], n_joints=n_j)
    extra = verts[..., _index(vertex_ids, verts.device), :]
    parts = [joints, extra]
    if n_j == 55 and use_face:
        if lmk is None:
            raise ValueError("use_face needs a landmark embedding "
                             "(models without lmk_faces_idx cannot fit "
                             "face keypoints)")
        lm = face_landmarks(verts, lmk)
        n_lm = 51 + 17 * use_face_contour
        parts.append(lm[..., :n_lm, :])
    full = torch.cat(parts, dim=-2)
    if n_j == 52:
        mapping = kp_lib.smplh_to_openpose(use_hands)
    elif n_j == 24:
        mapping = kp_lib.smpl_to_openpose()
    elif n_j == 55:
        mapping = kp_lib.smplx_to_openpose(
            use_hands, use_face, use_face_contour)
    else:
        raise ValueError(f"unsupported joint count {n_j} (24, 52 or 55)")
    return full[..., _index(mapping, full.device), :]
