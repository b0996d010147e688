"""SMPL-family body models on tensors (port of ``tpubody.models.smpl``).

``forward`` / ``forward_batch`` run the torch-op LBS of
:mod:`tpubody_torch.core.lbs` and return the whole posed state;
``forward_batch_verts`` is the throughput path, which on CUDA goes through
the fused LBS kernel (:mod:`tpubody_torch.core.fused_lbs`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.core import fused_lbs
from tpubody_torch.core import lbs as lbs_lib
from tpubody_torch.device import to_host
from tpubody_torch.mesh import meshio
from tpubody_torch.models.params import BodyModelParams
from tpubody_torch.utils.profiling import span


class BodyState(NamedTuple):
    """Posed body: everything downstream stages need from one forward pass."""

    verts: torch.Tensor           # (..., V, 3)
    joints_rest: torch.Tensor     # (..., J, 3)
    joints_posed: torch.Tensor    # (..., J, 3)
    rel_transforms: torch.Tensor  # (..., J, 4, 4)
    v_posed: torch.Tensor         # (..., V, 3)


def forward(
    model: BodyModelParams,
    pose: torch.Tensor,
    beta: torch.Tensor,
    trans: Optional[torch.Tensor] = None,
    pose_is_rotmat: bool = False,
) -> BodyState:
    """One LBS forward pass: pose (..., J, 3) axis-angle (or (..., J, 3, 3)
    rotation matrices), beta (..., S) (or betas ⊕ expression on a body
    with ``expr_dirs``: ``BodyModelParams.shape_basis``), trans (..., 3)."""
    out = lbs_lib.lbs(
        model.v_template,
        model.shape_basis(beta.shape[-1]),
        model.posedirs,
        model.j_regressor,
        model.weights,
        model.parents,
        pose,
        beta,
        trans,
        pose_is_rotmat=pose_is_rotmat,
    )
    return BodyState(
        verts=out.verts,
        joints_rest=out.joints,
        joints_posed=out.joints_posed,
        rel_transforms=out.rel_transforms,
        v_posed=out.v_posed,
    )


def forward_batch(
    model: BodyModelParams,
    pose: torch.Tensor,   # (F, J, 3) or (F, J, 3, 3)
    beta: torch.Tensor,   # (S,) shared or (F, S) per-frame
    trans: Optional[torch.Tensor] = None,  # (F, 3) or None
    pose_is_rotmat: bool = False,
) -> BodyState:
    """Batched LBS over frames."""
    return forward(model, pose, beta, trans, pose_is_rotmat)


def forward_batch_verts(
    model: BodyModelParams,
    poses: torch.Tensor,   # (F, J, 3) axis-angle or (F, J, 3, 3) rotmats
    beta: torch.Tensor,    # (S,) shared or (F, S) per-frame shape
    trans: Optional[torch.Tensor] = None,
    use_kernel: Optional[bool] = None,
    pose_is_rotmat: bool = False,
    kernel_precision: str = "bf16x3",
) -> torch.Tensor:
    """Vertices-only batched forward, the throughput path -> (F, V, 3).
    ``beta`` may hold betas ⊕ expression on a body with ``expr_dirs``
    (SMPL-X): the shape basis is then shapedirs ⊕ expr_dirs
    (``BodyModelParams.shape_basis``), on both paths.

    ``use_kernel=None`` launches the fused CUDA kernel when the model's
    tensors are on CUDA and runs :func:`forward_batch` when they are on the
    CPU.  ``use_kernel=True`` on CPU tensors raises: the kernel exists
    only on the card.  ``use_kernel=False`` asks for :func:`forward_batch`.
    ``kernel_precision``: "bf16x3" (the default, as in ``tpubody``) or
    "highest" (full fp32)."""
    on_cuda = model.device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda
    if use_kernel and not on_cuda:
        raise ValueError("use_kernel=True needs the body model on a CUDA "
                         f"device; it is on {model.device}")
    if use_kernel:
        n = beta.shape[-1]
        return fused_lbs.lbs_forward_batch_fused(
            model.v_template, model.shape_basis(n), model.posedirs,
            model.j_regressor, model.weights, model.parents,
            poses, beta, trans, pose_is_rotmat=pose_is_rotmat,
            kernel_precision=kernel_precision,
            layouts=fused_lbs.model_layouts(model, n))
    return forward_batch(model, poses, beta, trans,
                         pose_is_rotmat=pose_is_rotmat).verts


def forward_batch_placed(
    model: BodyModelParams,
    rotmats: torch.Tensor,  # (F, J, 3, 3)
    beta: torch.Tensor,     # (F, n)
    joint: int,
    point: torch.Tensor,    # (F, 3)
    kernel_precision: str = "bf16x3",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched vertices of bodies each placed so that its posed joint
    ``joint`` lies at ``point`` -> (verts (F, V, 3), translation (F, 3)).
    ``beta`` as :func:`forward_batch_verts` takes it.  On CUDA the joint
    comes from its transform in the fused path's prologue
    (:func:`fused_lbs.posed_joint`) and the translation goes into the
    kernel; on the CPU from :func:`forward_batch`'s posed joints."""
    if model.device.type != "cuda":
        state = forward_batch(model, rotmats, beta, pose_is_rotmat=True)
        transl = point - state.joints_posed[:, joint]
        return state.verts + transl[:, None], transl
    layouts = fused_lbs.model_layouts(model, beta.shape[-1])
    with span("lbs.prologue"):
        feat, g = fused_lbs.lbs_prologue(layouts, model.parents, rotmats,
                                         beta, pose_is_rotmat=True)
        transl = (point - fused_lbs.posed_joint(layouts, g, beta, joint)
                  ).contiguous()
    with span("fused_lbs"):
        verts = fused_lbs.fused_lbs(layouts, feat, g, transl,
                                    kernel_precision)
    return verts, transl


def regress_joints(model: BodyModelParams, verts: torch.Tensor) -> torch.Tensor:
    """3D joints from posed vertices: j_regressor (J, V) x verts (..., V, 3)."""
    return torch.matmul(model.j_regressor, verts)


def unpose(
    model: BodyModelParams,
    verts: torch.Tensor,
    state: BodyState,
    trans: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-skin vertices (..., V, 3) back to the rest pose of
    ``state`` (:func:`core.lbs.inverse_lbs` over its rest-relative
    transforms), on the device of the inputs."""
    return lbs_lib.inverse_lbs(verts, model.weights, state.rel_transforms,
                               trans)


def face_normals_z(verts: torch.Tensor, faces) -> torch.Tensor:
    """Z-component of (unnormalized) face normals, vectorized.

    Matches the sign convention of the reference's per-face loop
    (models/smplh_np.py:141-155): z = m_x*n_y - n_x*m_y with m = v1-v0,
    n = v2-v1.  verts (..., V, 3), faces (F, 3).
    """
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                        device=verts.device)
    v0 = verts[..., f[:, 0], :]
    v1 = verts[..., f[:, 1], :]
    v2 = verts[..., f[:, 2], :]
    m = v1 - v0
    n = v2 - v1
    return m[..., 0] * n[..., 1] - n[..., 0] * m[..., 1]


def divide_face(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray]:
    """Split a mesh into front-facing and back-facing halves (host side:
    the output shapes depend on the data).

    Returns ``(front_faces, front_verts, front_index, back_faces,
    back_verts, back_index)`` where faces are re-indexed into their own
    vertex arrays and ``*_index`` maps local -> original vertex ids, ordered
    by first appearance in face order (the reference's ordering contract,
    models/smplh_np.py:126-182).  Front is z <= 0 of
    :func:`face_normals_z`.
    """
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    z = face_normals_z(torch.as_tensor(verts), faces).numpy()

    def _half(sel_faces: np.ndarray):
        flat = sel_faces.reshape(-1)
        # Unique by first appearance: order unique ids by their first flat
        # position.
        uniq, first = np.unique(flat, return_index=True)
        index = uniq[np.argsort(first)].astype(np.int64)
        remap = np.full(verts.shape[0], -1, dtype=np.int64)
        remap[index] = np.arange(index.shape[0])
        return remap[sel_faces], verts[index], index

    ff, fv, fi = _half(faces[z <= 0])
    bf, bv, bi = _half(faces[z > 0])
    return ff, fv, fi, bf, bv, bi


def write_obj(path: str, verts, faces) -> None:
    """Minimal OBJ export, the bytes of ``tpubody``'s: arrays or tensors
    on any device (:func:`mesh.meshio.write_obj` on their host copies)."""
    meshio.write_obj(path, to_host(verts), to_host(faces))
