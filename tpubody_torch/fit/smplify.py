"""SMPLify-X style staged fitting: OpenPose keypoints -> SMPLH parameters
(port of ``tpubody.fit.smplify``).

Capability parity with the reference fitting subsystem
(lib/gen_smplh.py:34-177, lib/Gen_SMPLH/fit_single_frame.py:50-546,
fitting.py:36-503), laid out for the card as *lanes*:

  * every frame of a batch is a lane, and so is each of its two
    orientation candidates: the 5 weighted stages run the batched L-BFGS
    of :mod:`tpubody_torch.fit.lbfgs` once per stage over all 2N lanes,
    each lane with its own history, line search and stopping flag (the
    semantics of ``tpubody``'s ``jax.vmap`` over its while_loops);
  * the objective of all lanes is one batched SMPLH forward + VPoser
    decode + priors, and its gradient is ``torch.autograd.grad`` of the
    sum of the lanes' losses: no op of the objective mixes lanes;
  * the camera-depth initialization is the reference's limb-length ratio
    heuristic (fitting.py guess_init :36-110);
  * the 180-degree orientation flip (fit_single_frame.py:337-356) is
    evaluated as the second candidate lane of every frame and selected
    per frame where try_both_orient or the side-view shoulder test
    allows it, as ``tpubody``'s ``BatchFitter`` does.

The fitting path launches none of the port's CUDA kernels: the fit's
forward is the differentiable torch-op LBS on a reduced model, as
``tpubody``'s is ``lbs_lib.lbs`` and not its Pallas kernel.

Entry points take ``device="cuda"`` by default and raise without a card;
the tests pass ``device="cpu"``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.core.rotations import (rodrigues, rotmat_to_axis_angle)
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.fit import joints as joints_lib
from tpubody_torch.fit import keypoints as kp_lib
from tpubody_torch.fit import optim as optim_lib
from tpubody_torch.fit import priors as priors_lib
from tpubody_torch.fit import vposer as vposer_lib
from tpubody_torch.models import params as params_lib
from tpubody_torch.models import smpl as smpl_lib


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Defaults from fit_smplh.yaml + smpl_config.py (SURVEY.md §2 #27)."""

    # Body family (smpl_config.py:83-84 choices).  'smplh' is the
    # reference's only live configuration (fit_smplh.yaml:17); 'smpl'
    # fits the 24-joint body-only model (23-joint 69-dim body pose, no
    # articulated hands, BODY_25 keypoints only); 'smplx' fits the
    # 55-joint face+hands model (jaw/eye joints, expression blendshapes,
    # 51[+17] face landmarks when use_face).
    model_type: str = "smplh"
    # Gendered body-model selection (smpl_config.py:76-80; the live
    # fixture configs say male).  Host-side only: picks which asset
    # pipelines.gen_smplh.default_fit_model resolves.
    gender: str = "male"
    focal_length: float = 5000.0
    rho: float = 100.0
    optim_type: str = "lbfgsls"   # adam|lbfgs|lbfgsls|rmsprop|sgd
    lr: float = 1.0               # first-order optimizers only
    maxiters: int = 30
    ftol: float = 1e-9
    gtol: float = 1e-9
    use_vposer: bool = True
    use_hands: bool = True
    use_pca: bool = True          # PCA hand pose when the model carries
    num_pca_comps: int = 12       # hands_components (fit_smplh.yaml)
    # Which parameter groups the staged fit optimizes
    # (smpl_config.py:93-101): frozen groups keep their init values
    # (betas/hands from init_params, typically zeros = the mean shape /
    # rest hands) but still flow through the forward + priors.
    optim_shape: bool = True
    optim_hands: bool = True
    # Zero the hands' rest-pose mean (smpl_config.py:118-121): when False
    # (default) a model's hands_mean offsets the optimized hand pose, the
    # smplx convention.
    flat_hand_mean: bool = False
    try_both_orient: bool = False
    # Fit up to this many detected people per image (smpl_config.py:45-47;
    # the reference parses every person but fits only keypoints[[0]],
    # gen_smplh.py:158 — here persons fit in ONE batched program).
    max_persons: int = 3
    # When the 2D shoulder distance is under this many pixels the subject
    # is side-on and both orientations are tried regardless of
    # try_both_orient (reference fit_single_frame.py:287-290).  0 disables.
    side_view_thsh: float = 25.0
    # Body-pose prior when use_vposer is off: l2 | gmm (the reference's
    # 'mog' MaxMixture, prior.py:36-50,100-231; selected fitting.py:385-388).
    body_prior_type: str = "l2"
    num_gaussians: int = 8
    # Per-parameter-group step scales (key of the optimized param dict ->
    # float), a diagonal preconditioner on the minimizer (fit.optim
    # _with_scales).  Counters compensation valleys on redundant chains:
    # e.g. {"jaw": 8.0} lets the SMPL-X jaw articulate instead of being
    # absorbed by global pose/shape.  None = identity (reference behavior;
    # its torch LBFGS had no group scaling either).
    param_scales: Optional[Mapping[str, float]] = None
    prior_folder: str = ""        # dir holding gmm_{num_gaussians:02d}.pkl
    use_joints_conf: bool = True  # scale joint weights by detector conf
    joints_to_ign: Tuple[int, ...] = (1, 9, 12)
    init_joints_idxs: Tuple[int, ...] = (9, 12, 2, 5)
    body_tri_idxs: Tuple[Tuple[int, int], ...] = ((5, 12), (2, 9))
    depth_loss_weight: float = 1e2
    data_weights: Tuple[float, ...] = (1.0,) * 5
    body_pose_prior_weights: Tuple[float, ...] = (404.0, 404.0, 57.4,
                                                  4.78, 4.78)
    shape_weights: Tuple[float, ...] = (100.0, 50.0, 10.0, 5.0, 5.0)
    hand_pose_prior_weights: Tuple[float, ...] = (404.0, 404.0, 57.4,
                                                  4.78, 4.78)
    hand_joints_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.1, 2.0)
    bending_prior_scale: float = 3.17   # fit_single_frame.py:382-383
    # SMPL-X face surface (smpl_config.py:90-98,137-141,186-202,232-238):
    # fit the 51 FLAME landmarks (+17 jawline contour) with per-stage
    # weights, optimize jaw pose / expression coefficients under L2-style
    # priors.  Eye poses are created but unconstrained by any keypoint, so
    # they stay at identity (the reference optimizes them to no effect).
    use_face: bool = False
    use_face_contour: bool = False
    optim_jaw: bool = True
    optim_expression: bool = True
    num_expression_coeffs: int = 10
    jaw_prior_type: str = "l2"
    expr_weights: Tuple[float, ...] = (100.0, 50.0, 10.0, 5.0, 5.0)
    face_joints_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.1, 2.0)
    # Per-stage (pitch, yaw, roll) jaw-pose L2 scales; None derives the
    # reference's fallback [[w]*3 for w in body_pose_prior_weights].
    jaw_pose_prior_weights: Optional[Tuple[Tuple[float, float, float],
                                           ...]] = None
    # Self-collision term (fit_smplh.yaml:36,59-64 — off by default there
    # too).  "sphere" = fit.collision sphere proxy (cheap); "mesh" =
    # fit.mesh_collision dense cone-distance-field term, the dense
    # equivalent of the reference's BVH + distance-field penalty
    # (fitting.py:404-442).  coll_cone_scale is the df_cone_height analog
    # (smpl_config.py:216-219), in triangle circumradii.
    interpenetration: bool = False
    coll_loss_weights: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.01, 1.0)
    coll_n_samples: int = 1024
    coll_mode: str = "sphere"
    coll_n_faces: int = 2048
    coll_cone_scale: float = 2.0
    # Video fitting (fit_sequence, chained): quadratic anchor pulling each
    # frame's pose / global orientation toward the previous frame's
    # solution — temporal smoothing the reference has no counterpart for
    # (it fits stills only).  0 disables; anchored frames carry a per-lane
    # anchor weight.
    temporal_weight: float = 0.0
    # Optimization (no reference counterpart): run the staged
    # fit on an exact reduced model — virtual joint rows (collapsed
    # J_regressor) + only the surface vertices the objective reads
    # (params.restrict_model) — instead of the full V-vertex LBS.  The
    # collision proxies' sampled vertex/face rows are included and
    # remapped, so interpenetration fits reduce too (sphere mode keeps
    # ~1k of 6890 rows; mesh mode most of them).  Identical
    # losses/solutions to within float roundoff; set False to force the
    # full-vertex forward.
    reduce_verts: bool = True
    # Warm-start iteration budgets for chained video fitting (no reference
    # counterpart — it fits stills with the full <=30x5x2 budget every
    # frame, fit_smplh.yaml:49).  Frames >= 1 of fit_sequence start from
    # the previous frame's solution, so they need a fraction of the
    # budget: warm_maxiters caps each stage's L-BFGS iterations and
    # warm_cam_maxiters the camera-stage iterations (0 = the previous
    # frame's camera/orientation pass through — only safe for a STATIC
    # camera: a frozen camera stage cannot track subject/camera motion,
    # which is why the default is a small nonzero budget).  Both are
    # per-call budgets of the same fitter.  None disables (full budget
    # every frame).
    warm_maxiters: Optional[int] = 10
    warm_cam_maxiters: int = 5


class FitOutput(NamedTuple):
    pose: np.ndarray            # (156,) global + body63 + hands90
    #                             ((72,) SMPL; (165,) SMPL-X with jaw+eyes)
    shape: np.ndarray           # (10,)
    camera_translation: np.ndarray  # (3,)
    camera_rotation: np.ndarray     # (3, 3)
    camera_center: np.ndarray       # (2,)
    camera_fx: float
    pose_embedding: np.ndarray  # (32,)
    loss: float
    expression: Optional[np.ndarray] = None   # (E,) SMPL-X only


class FitBatchOutput(NamedTuple):
    pose: np.ndarray                # (N, 156) — (N, 72)/(N, 165) smpl/smplx
    shape: np.ndarray               # (N, 10)
    camera_translation: np.ndarray  # (N, 3)
    camera_center: np.ndarray       # (N, 2)
    camera_fx: float
    pose_embedding: np.ndarray      # (N, 32)
    loss: np.ndarray                # (N,)
    expression: Optional[np.ndarray] = None   # (N, E) SMPL-X only


# The per-frame fields of a FitBatchOutput (camera_fx is shared).
FRAME_FIELDS = ("pose", "shape", "camera_translation", "camera_center",
                "pose_embedding", "loss", "expression")


def _project(joints3d, cam_t, focal, center):
    """PerspectiveCamera parity (lib/Gen_SMPLH/camera.py:104-117):
    x_cam = x + t (identity rotation), pinhole projection.  ``joints3d``
    (..., K, 3); ``cam_t`` (..., 3) and ``center`` (..., 2) per lane.

    Depth is clamped to 1cm: line-search trial points with the camera
    behind the body would otherwise overflow fp32 through the squared
    reprojection error and poison L-BFGS with NaNs."""
    cam = joints3d + cam_t.unsqueeze(-2)
    z = torch.clamp(cam[..., 2:3], min=1e-2)
    return cam[..., :2] / z * focal + center.unsqueeze(-2)


def _hand_aa(p, key, basis):
    """Hand axis-angle (..., 45) from either full aa or PCA coefficients
    (smplx use_pca parity: aa = mean + coeffs @ components; the mean also
    applies to the full-aa parameterization unless flat_hand_mean)."""
    val = p[key] if key in p else torch.zeros(45)
    if basis is None:
        return val
    components, mean = basis
    if components is None:
        return mean + val
    return mean + val @ components


def _forward_joints(model, decoder, p, use_vposer, focal, center,
                    vertex_ids, hand_bases=(None, None), use_hands=True,
                    lmk=None, use_face=False, use_face_contour=False,
                    n_expr=0):
    """SMPLH/SMPL/SMPL-X forward of every lane -> projected OpenPose
    joints (B, K, 2), VPoser's body rotations, the LBS state.

    VPoser's decoded rotation MATRICES feed LBS directly
    (``pose_is_rotmat``), skipping the rotmat -> axis-angle -> rodrigues
    detour of the reference.  ``model.num_joints`` selects the family: 52
    SMPLH, 24 SMPL (VPoser's 21 joints + identity wrists), 55 SMPL-X
    (21 body + jaw + 2 eyes + 2x15 hands; the caller folds the expression
    blendshapes into ``shapedirs`` and passes ``n_expr``)."""
    nj = model.num_joints
    B = p["global_orient"].shape[0]
    dev, dt = p["global_orient"].device, p["global_orient"].dtype
    n_body = 21 if nj in (52, 55) else nj - 1
    if use_vposer:
        body_R = decoder(p["pose_embedding"])
        if body_R.shape[1] < n_body:   # SMPL: identity hand joints 22/23
            eye = torch.eye(3, dtype=dt, device=dev).expand(
                B, n_body - body_R.shape[1], 3, 3)
            body_R = torch.cat([body_R, eye], dim=1)
    else:
        body_R = rodrigues(p["body_pose"].reshape(B, n_body, 3))
    parts = [rodrigues(p["global_orient"].reshape(B, 1, 3)), body_R]
    if nj == 55:
        # Jaw + eyes under the head; the eyes carry no keypoint and stay
        # identity.
        jaw = p["jaw"] if "jaw" in p else torch.zeros(B, 3, dtype=dt,
                                                      device=dev)
        parts.append(rodrigues(jaw.reshape(B, 1, 3)))
        parts.append(torch.eye(3, dtype=dt, device=dev).expand(B, 2, 3, 3))
    if nj in (52, 55):
        parts += [
            rodrigues(_hand_aa(p, "lhand", hand_bases[0]).reshape(B, 15, 3)),
            rodrigues(_hand_aa(p, "rhand", hand_bases[1]).reshape(B, 15, 3)),
        ]
    R = torch.cat(parts, dim=1)                    # (B, nj, 3, 3)
    beta = p["betas"]
    if n_expr:
        expr = p["expression"] if "expression" in p else torch.zeros(
            B, n_expr, dtype=dt, device=dev)
        beta = torch.cat([beta, expr], dim=-1)
    state = smpl_lib.forward(model, R, beta, pose_is_rotmat=True)
    j_op = joints_lib.openpose_joints(state.verts, state.joints_posed,
                                      vertex_ids=vertex_ids,
                                      use_hands=use_hands,
                                      lmk=lmk, use_face=use_face,
                                      use_face_contour=use_face_contour)
    return _project(j_op, p["cam_t"], focal, center), body_R, state


def guess_init_depth(joints3d_op: torch.Tensor, joints2d: torch.Tensor,
                     body_tri_idxs, focal: float) -> torch.Tensor:
    """Camera depth from mean limb-length ratio (fitting.py:36-110):
    joints3d_op (..., K, 3), joints2d (..., K, 2) -> (...,)."""
    d3, d2 = [], []
    for a, b in body_tri_idxs:
        d3.append(torch.linalg.norm(joints3d_op[..., a, :]
                                    - joints3d_op[..., b, :], dim=-1))
        d2.append(torch.linalg.norm(joints2d[..., a, :]
                                    - joints2d[..., b, :], dim=-1))
    h3 = torch.mean(torch.stack(d3, dim=-1), dim=-1)
    h2 = torch.clamp(torch.mean(torch.stack(d2, dim=-1), dim=-1), min=1e-6)
    return focal * h3 / h2


# --- shared per-config setup --------------------------------------------

def _setup_hand_bases(model, config: FitConfig):
    """PCA hand bases when configured and available: ((comps, mean) x2,
    hand_dim).  SMPL (24 joints) has no articulated hands: dim 0.

    flat_hand_mean zeroes the rest-pose mean; otherwise the model's
    hands_mean offsets BOTH the PCA and the full-aa parameterizations."""
    hand_bases = (None, None)
    if model.num_joints not in (52, 55):
        return hand_bases, 0
    hand_dim = 45
    flat = getattr(config, "flat_hand_mean", False)
    zeros = torch.zeros(45, dtype=model.v_template.dtype,
                        device=model.device)
    ml = model.hands_mean_l if (model.hands_mean_l is not None
                                and not flat) else zeros
    mr = model.hands_mean_r if (model.hands_mean_r is not None
                                and not flat) else zeros
    if (config.use_pca and model.hands_components_l is not None
            and model.hands_components_r is not None):
        n = config.num_pca_comps
        hand_bases = ((model.hands_components_l[:n], ml),
                      (model.hands_components_r[:n], mr))
        hand_dim = n
    elif (model.hands_mean_l is not None
          or model.hands_mean_r is not None):
        hand_bases = ((None, ml), (None, mr))
    return hand_bases, hand_dim


class _FamilySetup(NamedTuple):
    """Model-family-dependent fit setup shared by every entry point."""
    fit_model: object          # model, with expression dirs folded into
    #                            shapedirs for SMPL-X; reduced when
    #                            config.reduce_verts
    use_hands: bool
    use_face: bool
    use_face_contour: bool
    body_dim: int              # 63 for SMPLH/SMPL-X, 69 for SMPL
    n_expr: int                # optimized expression coefficients (0 = off)
    lmk: object                # (vert_ids, bary) landmark gather or None
    jw: torch.Tensor           # per-keypoint-row base weights
    vertex_ids: torch.Tensor
    coll_fn: object            # verts -> (B,) penalty, or None


def _setup_family(model, config: FitConfig) -> _FamilySetup:
    nj = model.num_joints
    if nj not in (24, 52, 55):
        raise ValueError(f"unsupported body family: {nj} joints "
                         "(24=SMPL, 52=SMPLH, 55=SMPL-X)")
    dev = model.device
    use_hands = config.use_hands and nj in (52, 55)
    body_dim = 63 if nj in (52, 55) else 3 * (nj - 1)
    use_face = config.use_face and nj == 55
    use_face_contour = use_face and config.use_face_contour
    n_expr = 0
    fit_model = model
    lmk = None
    if nj == 55:
        if config.optim_expression and model.expr_dirs is not None:
            n_expr = min(config.num_expression_coeffs,
                         model.num_expressions)
            fit_model = dataclasses.replace(
                model, cache={}, shapedirs=torch.cat(
                    [model.shapedirs, model.expr_dirs[:, :, :n_expr]],
                    dim=-1))
        if use_face:
            lmk = joints_lib.landmark_gather(model)
            if lmk is None:
                raise ValueError(
                    "use_face needs a model with a face-landmark embedding "
                    "(lmk_faces_idx/lmk_bary_coords)")
    jw = torch.as_tensor(kp_lib.joint_weights(
        config.joints_to_ign, use_hands, use_face, use_face_contour),
        dtype=torch.float32, device=dev)
    vertex_ids = joints_lib.extra_vertex_ids(model.num_verts, n_joints=nj)
    coll = _setup_collision(model, config)   # (loss_fn, full-model proxy)
    if config.reduce_verts:
        # The objective only reads joints + these vertex rows (extra
        # joints, face landmarks, collision-proxy samples): swap in the
        # exact reduced model and remap every gather into it.
        pieces = [np.asarray(vertex_ids, np.int64).reshape(-1)]
        if lmk is not None:
            pieces.append(np.asarray(lmk[0], np.int64).reshape(-1))
        if coll is not None:
            proxy = coll[1]
            if hasattr(proxy, "face_vids"):
                pieces.append(np.asarray(proxy.face_vids,
                                         np.int64).reshape(-1))
            pieces.append(np.asarray(proxy.vertex_idx,
                                     np.int64).reshape(-1))
        sizes = np.cumsum([p.size for p in pieces])
        fit_model, rows = params_lib.restrict_model(
            fit_model, np.concatenate(pieces))
        parts = np.split(rows, sizes[:-1])
        vertex_ids = parts[0]
        k = 1
        if lmk is not None:
            lmk = (parts[k].reshape(np.asarray(lmk[0]).shape), lmk[1])
            k += 1
        if coll is not None:
            loss_fn, proxy = coll
            if hasattr(proxy, "face_vids"):
                proxy = proxy._replace(
                    face_vids=parts[k].reshape(-1, 3).astype(np.int32),
                    vertex_idx=parts[k + 1].astype(np.int32))
            else:
                proxy = proxy._replace(
                    vertex_idx=parts[k].astype(np.int32))
            coll = (loss_fn, proxy)
    if lmk is not None:     # the landmark tables move to the card once
        lmk = (torch.as_tensor(np.asarray(lmk[0], np.int64), device=dev),
               torch.as_tensor(np.asarray(lmk[1]), dtype=torch.float32,
                               device=dev))
    coll_fn = None
    if coll is not None:
        from tpubody_torch.fit import collision as coll_lib
        from tpubody_torch.fit import mesh_collision as mcoll_lib
        loss_fn, proxy = coll
        lib = mcoll_lib if hasattr(proxy, "face_vids") else coll_lib
        coll_fn = functools.partial(loss_fn,
                                    proxy=lib.to_device(proxy, dev))
    return _FamilySetup(
        fit_model, use_hands, use_face, use_face_contour, body_dim, n_expr,
        lmk, jw, torch.as_tensor(np.asarray(vertex_ids, np.int64),
                                 device=dev), coll_fn)


def _setup_gmm(config: FitConfig, body_dim: int = 63,
               device: DeviceLike = "cpu"):
    """GMM body-pose prior for the non-VPoser path (body_prior_type gmm /
    mog).  ``body_dim`` is 63 for SMPLH (21 body joints), 69 for SMPL."""
    if config.use_vposer or config.body_prior_type not in ("gmm", "mog"):
        return None
    gmm_path = os.path.join(
        config.prior_folder, f"gmm_{config.num_gaussians:02d}.pkl") \
        if config.prior_folder else ""
    if gmm_path and os.path.exists(gmm_path):
        gmm_prior = priors_lib.load_gmm(gmm_path, device=device)
        if gmm_prior.means.shape[1] < body_dim:
            raise ValueError(
                f"GMM prior is {gmm_prior.means.shape[1]}-dim; the model's "
                f"body pose needs {body_dim}")
        if gmm_prior.means.shape[1] != body_dim:
            # SMPLify GMM pickles are 69-dim (23 SMPL body joints);
            # SMPLH body pose is 63-dim — keep the shared prefix.
            gmm_prior = priors_lib.GMMPrior(
                means=gmm_prior.means[:, :body_dim],
                precisions=gmm_prior.precisions[:, :body_dim, :body_dim],
                log_norm=gmm_prior.log_norm)
        return gmm_prior
    return priors_lib.synthetic_gmm(
        n_components=config.num_gaussians, dim=body_dim, device=device)


def _setup_collision(model, config: FitConfig):
    """Optional self-collision penalty: ``(loss_fn, proxy)`` or None.  The
    proxy is built on the host and indexes the FULL model's vertices;
    _setup_family remaps it when the fit runs on a reduced model."""
    if not config.interpenetration:
        return None
    v_t = model.v_template.detach().cpu().numpy()
    w = model.weights.detach().cpu().numpy()
    if config.coll_mode == "mesh":
        from tpubody_torch.fit import mesh_collision as mcoll_lib
        mesh_proxy = mcoll_lib.build_mesh_collision(
            v_t, np.asarray(model.faces), w, np.asarray(model.parents),
            n_faces=config.coll_n_faces, n_verts=config.coll_n_samples,
            cone_scale=config.coll_cone_scale)
        return mcoll_lib.mesh_penetration_loss, mesh_proxy
    from tpubody_torch.fit import collision as coll_lib
    coll_proxy = coll_lib.build_collision_proxy(
        v_t, w, np.asarray(model.parents), n_samples=config.coll_n_samples)
    return coll_lib.penetration_loss, coll_proxy


def _make_body_loss(fam: _FamilySetup, decoder, config: FitConfig, focal,
                    hand_bases, gmm_prior, coll_fn):
    """The staged-fit objective (reference SMPLifyLoss,
    fitting.py:365-449), shared by every entry point.

    Returns ``loss(p, w, gt2d, conf, center, anchor=None) -> (B,)``: ``p``
    a dict of (B, ...) lane parameters, ``w`` one stage's weights (see
    :func:`stage_weight_dicts`), ``anchor`` an optional ``(anchor_w,
    pose_init, orient_init, pose_key)`` temporal term (anchor_w (B,), 0
    disables a lane)."""
    model = fam.fit_model
    use_hands = fam.use_hands
    jw = fam.jw
    n_hand_rows = 2 * 21 if use_hands else 0
    face_start = 25 + n_hand_rows

    def body_loss(p, w, gt2d, conf, center, anchor=None):
        proj, body_R, state = _forward_joints(
            model, decoder, p, config.use_vposer, focal, center,
            fam.vertex_ids, hand_bases, use_hands=use_hands, lmk=fam.lmk,
            use_face=fam.use_face, use_face_contour=fam.use_face_contour,
            n_expr=fam.n_expr)
        B = proj.shape[0]
        # Smooth axis-angle proxy from the rotation skew part
        # (sin(theta)*axis): sign- and monotonicity-preserving on the bend
        # range, and differentiable everywhere (unlike exact mat2aa).
        body63 = torch.stack([
            (body_R[:, :, 2, 1] - body_R[:, :, 1, 2]) / 2,
            (body_R[:, :, 0, 2] - body_R[:, :, 2, 0]) / 2,
            (body_R[:, :, 1, 0] - body_R[:, :, 0, 1]) / 2,
        ], dim=-1).reshape(B, -1)
        weights = jw * conf if config.use_joints_conf else jw.expand(
            conf.shape)
        tail = weights[:, face_start:]
        if fam.use_face:      # per-stage face-landmark weight (SMPL-X)
            tail = tail * w["face_joints"]
        weights = torch.cat([weights[:, :25],
                             weights[:, 25:face_start] * w["hand_joints"],
                             tail], dim=1)
        diff = priors_lib.gmof(gt2d - proj, config.rho)
        joint_loss = torch.sum(weights[:, :, None] ** 2 * diff,
                               dim=(1, 2)) * w["data"] ** 2
        if config.use_vposer:
            pprior = torch.sum(p["pose_embedding"] ** 2, dim=-1) \
                * w["body_pose"] ** 2
        elif gmm_prior is not None:
            pprior = priors_lib.max_mixture_prior(
                p["body_pose"], gmm_prior) * w["body_pose"] ** 2
        else:
            pprior = priors_lib.l2_prior(p["body_pose"]) \
                * w["body_pose"] ** 2
        shape_loss = priors_lib.l2_prior(p["betas"]) * w["shape"] ** 2
        # Elbow/knee indices (52,55,9,12 after dropping global orient) all
        # fall inside the 63-dim body pose (reference fitting.py:399-402).
        bend = torch.sum(priors_lib.angle_prior(body63), dim=-1) \
            * w["bending"]
        total = joint_loss + pprior + shape_loss + bend
        if "lhand" in p:
            total = total + (priors_lib.l2_prior(p["lhand"])
                             + priors_lib.l2_prior(p["rhand"])) \
                * w["hand_prior"] ** 2
        # SMPL-X face terms (reference fitting.py:412-423): L2 expression
        # prior scaled by expr_weight^2; jaw L2 with a per-axis
        # (pitch, yaw, roll) scale INSIDE the square.
        face = 0.0
        if "expression" in p:
            face = face + priors_lib.l2_prior(p["expression"]) \
                * w["expr"] ** 2
        if "jaw" in p:
            face = face + torch.sum((p["jaw"] * w["jaw"]) ** 2, dim=-1)
        total = total + face
        if coll_fn is not None:
            total = total + w["coll"] * coll_fn(state.verts)
        if anchor is not None:
            # Anchor to the previous frame's solution (= this frame's warm
            # start in fit_sequence's chained mode).
            anchor_w, pose_init, orient_init, pose_key = anchor
            total = total + anchor_w * (
                torch.sum((p[pose_key] - pose_init) ** 2, dim=-1)
                + torch.sum((p["global_orient"] - orient_init) ** 2,
                            dim=-1))
        return total

    return body_loss


def _stage_weights(config: FitConfig) -> Dict[str, np.ndarray]:
    """Per-stage weight schedule stacked on a leading stage axis, float32
    as ``tpubody`` stacks it.  body_pose_prior_weights defines the stage
    count; other schedules may be LONGER and are truncated, but a schedule
    SHORTER than the stage count raises (pipelines.gen_smplh.load_config
    enforces explicit-length consistency)."""
    n_stages = len(config.body_pose_prior_weights)
    jaw = config.jaw_pose_prior_weights
    if jaw is None:
        jaw = tuple((w,) * 3 for w in config.body_pose_prior_weights)
    else:
        jaw = tuple(tuple(float(x) for x in row) for row in jaw)
        if any(len(row) != 3 for row in jaw):
            raise ValueError("jaw_pose_prior_weights rows must be "
                             "(pitch, yaw, roll) triples")
    ws = {
        "data": config.data_weights[:n_stages],
        "body_pose": config.body_pose_prior_weights,
        "shape": config.shape_weights[:n_stages],
        "bending": [config.bending_prior_scale * b
                    for b in config.body_pose_prior_weights],
        "hand_prior": config.hand_pose_prior_weights[:n_stages],
        "hand_joints": (config.hand_joints_weights[:n_stages]
                        if config.use_hands else [0.0] * n_stages),
        "coll": (config.coll_loss_weights[:n_stages]
                 if config.interpenetration else [0.0] * n_stages),
        "expr": (config.expr_weights[:n_stages]
                 if config.model_type == "smplx" else [0.0] * n_stages),
        "face_joints": (config.face_joints_weights[:n_stages]
                        if config.model_type == "smplx" and config.use_face
                        else [0.0] * n_stages),
        "jaw": (jaw[:n_stages] if config.model_type == "smplx"
                else [(0.0,) * 3] * n_stages),
    }
    for k, v in ws.items():
        if len(v) != n_stages:
            raise ValueError(
                f"config weight schedule '{k}' has {len(v)} entries; "
                f"expected {n_stages} (one per stage, reference "
                "fit_single_frame.py:110-147 consistency asserts)")
    return {k: np.asarray(v, np.float32) for k, v in ws.items()}


def stage_weight_dicts(config: FitConfig, device: DeviceLike = "cpu"):
    """One weight dict per stage: float32 scalars as Python floats (exact)
    and the jaw's (3,) scale as a tensor on ``device``."""
    ws = _stage_weights(config)
    n = len(config.body_pose_prior_weights)
    out = []
    for s in range(n):
        w = {k: float(v[s]) for k, v in ws.items() if k != "jaw"}
        w["jaw"] = torch.as_tensor(ws["jaw"][s], device=device)
        out.append(w)
    return out


def _as_decoder(dec_params, seed: int, device) -> vposer_lib.VPoserDecoder:
    """``dec_params``: a VPoserDecoder, ``tpubody``'s flax param tree as
    numpy, or None for a seeded decoder."""
    if dec_params is None:
        return vposer_lib.create_decoder(seed, device=device)
    if isinstance(dec_params, torch.nn.Module):
        return dec_params.to(device).requires_grad_(False)
    dec, _ = vposer_lib.from_flax_params(dec_params, device=device)
    return dec


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BatchFitter:
    """Batched SMPLify over lanes (the engine behind every fit entry).

    Construct once per (model, config); each call fits N frames as 2N
    lanes (both orientation candidates of every frame; the flip is
    selected per frame where try_both_orient or the side-view shoulder
    test allows it).  There is no compile step, so unlike ``tpubody``'s
    it pads no batch to a bucket size, except under ``mesh=``
    (``dist.mesh``): there, as in ``tpubody``, the frames pad to the next
    power of two and then to a multiple of the mesh size, each device
    fits its share of the lanes on its own replica of the fitter
    (:meth:`replica`; the shards run one after another, each fit being
    host-paced), and the padding is cut off.  The bucket keeps the lane
    counts, and so each replica's CUDA graphs, few.

    ``stats`` after a call holds the camera stage's and the body stages'
    counters (iterations, objective evaluations, line-search steps,
    device-to-host reads) and ``split_ms()`` their wall times on the
    device's clock.  On CUDA each stage's objective is replayed as a CUDA
    graph, captured once per lane count (see :mod:`tpubody_torch.fit.lbfgs`).
    """

    def __init__(self,
                 model: params_lib.BodyModelParams,
                 config: FitConfig = FitConfig(),
                 dec_params=None,
                 seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.device = dev = resolve(device)
        self.model = model.to(dev) if model.device != dev else model
        self.config = config
        self.decoder = _as_decoder(dec_params, seed, dev)
        model = self.model
        self.nj = nj = model.num_joints
        fam = _setup_family(model, config)
        self.fam = fam
        self.hand_bases, self.hand_dim = _setup_hand_bases(model, config)
        self.body_dim = fam.body_dim
        self.n_expr = fam.n_expr
        self.pose_dim = 32 if config.use_vposer else fam.body_dim
        self.pose_key = "pose_embedding" if config.use_vposer \
            else "body_pose"
        gmm_prior = _setup_gmm(config, fam.body_dim, dev)
        self.focal = config.focal_length
        self.opt = optim_lib.create_optimizer(
            config.optim_type, lr=config.lr, maxiters=config.maxiters,
            ftol=config.ftol, gtol=config.gtol,
            param_scales=config.param_scales)
        self.ws = stage_weight_dicts(config, dev)
        self.n_stages = len(self.ws)
        self.shared_loss = _make_body_loss(
            fam, self.decoder, config, self.focal, self.hand_bases,
            gmm_prior, fam.coll_fn)
        self.init_idxs = torch.as_tensor(config.init_joints_idxs,
                                         device=dev)
        with torch.no_grad():
            # Frame-independent zero-pose joints for the depth guess.
            state0 = smpl_lib.forward(
                fam.fit_model, torch.zeros(nj, 3, device=dev),
                torch.zeros(10 + fam.n_expr, device=dev))
            self.j0 = joints_lib.openpose_joints(
                state0.verts, state0.joints_posed, use_hands=fam.use_hands,
                vertex_ids=fam.vertex_ids)
            self.Rflip = rodrigues(torch.tensor([0.0, np.pi, 0.0],
                                                device=dev))
        self.stats: Dict[str, Dict[str, int]] = {}
        self._events = None
        self._bufs: Dict[Any, Dict[str, torch.Tensor]] = {}
        self._zeros: Dict[int, Dict[str, torch.Tensor]] = {}
        self._graphs: Dict[Any, Any] = {}
        self._replicas: Dict[torch.device, "BatchFitter"] = {}

    def replica(self, device: DeviceLike) -> "BatchFitter":
        """This fitter on ``device`` (itself on its own device), made once:
        the same model, configuration and decoder weights."""
        from tpubody_torch.dist import mesh as mesh_lib

        dev = mesh_lib.canonical(resolve(device))
        if dev == mesh_lib.canonical(self.device):
            return self
        if dev not in self._replicas:
            self._replicas[dev] = BatchFitter(
                self.model, self.config,
                dec_params=copy.deepcopy(self.decoder), device=dev)
        return self._replicas[dev]

    def _fit_sharded(self, inputs, cam_iters, stage_iters, mesh):
        """``_fit``'s eight (N, ...) inputs over the devices of ``mesh``
        (class docstring) -> its output dict on this fitter's device."""
        from tpubody_torch.dist import mesh as mesh_lib

        N = inputs[0].shape[0]
        B = 1 << max(N - 1, 0).bit_length()
        if B != N:                     # the bucket repeats the first frame
            inputs = [torch.cat([x, x[:1].expand(B - N, *x.shape[1:])])
                      for x in inputs]
        pieces = [mesh_lib.split_frames(mesh_lib.pad_frames(x, mesh.size),
                                        mesh.size) for x in inputs]
        outs = []
        for i, dev in enumerate(mesh.devices):
            with mesh_lib.on_device(dev):
                outs.append(self.replica(dev)._fit(
                    *[p[i].to(dev) for p in pieces], cam_iters,
                    stage_iters))
        return {k: torch.cat([o[k].to(self.device) for o in outs])[:N]
                for k in outs[0]}

    # -- the fit of a batch of lanes ------------------------------------
    def _zeros_p(self, B):
        dev = self.device
        z = {"global_orient": torch.zeros(B, 3, device=dev),
             "betas": torch.zeros(B, 10, device=dev),
             "pose_embedding": torch.zeros(B, 32, device=dev),
             "body_pose": torch.zeros(B, self.body_dim, device=dev),
             "cam_t": torch.zeros(B, 3, device=dev)}
        if self.nj in (52, 55):
            z["lhand"] = torch.zeros(B, self.hand_dim, device=dev)
            z["rhand"] = torch.zeros(B, self.hand_dim, device=dev)
        return z

    def _static(self, key, **tensors) -> Dict[str, torch.Tensor]:
        """Buffers of one lane count that the objectives read, refilled in
        place on every call (a captured graph holds their addresses)."""
        bufs = self._bufs.get(key)
        if bufs is None or any(bufs[k].shape != v.shape
                               for k, v in tensors.items()):
            bufs = self._bufs[key] = {k: v.detach().clone()
                                      for k, v in tensors.items()}
        else:
            for k, v in tensors.items():
                bufs[k].copy_(v)
        return bufs

    def _graph_key(self, key):
        return (self._graphs, key) if self.device.type == "cuda" else None

    def _mark(self):
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def split_ms(self) -> Tuple[float, float]:
        """(camera stage ms, body stages ms) of the last call."""
        e0, e1, e2 = self._events
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return e0.elapsed_time(e1), e1.elapsed_time(e2)
        return 1e3 * (e1 - e0), 1e3 * (e2 - e1)

    def _fit(self, kps, centers, init_t, has_init, betas0, pose0, orient0,
             anchor_w, cam_iters, stage_iters, extra=None, both=True):
        """All inputs are (N, ...) tensors on the device.  ``extra`` holds
        optional initial lhand/rhand/jaw/expression; ``both=False`` fits
        only the unflipped candidate."""
        config, fam, nj = self.config, self.fam, self.nj
        extra = extra or {}
        N = kps.shape[0]
        dev = self.device
        cam_stats, stage_stats = {}, {}
        self.stats = {"camera": cam_stats, "stages": stage_stats}
        e0 = self._mark()
        gt2d = kps[:, :, :2]
        conf = kps[:, :, 2]
        est_d = torch.where(
            has_init, init_t[:, 2],
            guess_init_depth(self.j0, gt2d, config.body_tri_idxs,
                             self.focal))
        cam0 = torch.where(has_init[:, None], init_t,
                           torch.tensor([0.0, 0.0, 1.0], device=dev)
                           * est_d[:, None])
        # The objectives read their per-call data from buffers kept per
        # lane count, so a captured graph replays on the next call's data.
        cam = self._static(("camera", N), gt2d=gt2d, center=centers,
                           est_d=est_d)
        if N not in self._zeros:
            self._zeros[N] = self._zeros_p(N)
        zeros_p = self._zeros[N]
        init_idxs = self.init_idxs

        def camera_loss(p):
            proj, _, _ = _forward_joints(
                fam.fit_model, self.decoder,
                {**zeros_p, "cam_t": p["cam_t"],
                 "global_orient": p["global_orient"]},
                config.use_vposer, self.focal, cam["center"],
                fam.vertex_ids, self.hand_bases, use_hands=fam.use_hands,
                n_expr=fam.n_expr)
            err = torch.sum((cam["gt2d"][:, init_idxs]
                             - proj[:, init_idxs]) ** 2, dim=(1, 2))
            depth = config.depth_loss_weight ** 2 * \
                (p["cam_t"][:, 2] - cam["est_d"]) ** 2
            return err + depth

        cam_res = self.opt.minimize(
            camera_loss, {"cam_t": cam0, "global_orient": orient0},
            maxiters_op=cam_iters, stats=cam_stats,
            graph=self._graph_key(("camera", N)))
        cam_t0 = cam_res.params["cam_t"]
        orient_a = cam_res.params["global_orient"]
        e1 = self._mark()

        orient_b = rotmat_to_axis_angle(rodrigues(orient_a) @ self.Rflip)
        shoulder = torch.linalg.norm(gt2d[:, 2] - gt2d[:, 5], dim=-1)
        allow_flip = (shoulder < config.side_view_thsh) | bool(
            config.try_both_orient)

        reps = 2 if both else 1

        def lanes(t):
            return torch.cat([t] * reps, dim=0) if reps > 1 else t

        L = N * reps
        hand0 = torch.zeros(N, self.hand_dim, device=dev)
        data = {"gt2d": lanes(gt2d), "conf": lanes(conf),
                "center": lanes(centers)}
        if config.temporal_weight > 0.0:
            data.update(anchor_w=lanes(anchor_w), pose_init=lanes(pose0),
                        orient_init=lanes(orient0))
        frozen_keys = []
        if not config.optim_shape:
            data["frozen_betas"] = lanes(betas0)
            frozen_keys.append("betas")
        if nj in (52, 55) and not config.optim_hands:
            data["frozen_lhand"] = lanes(extra.get("lhand", hand0))
            data["frozen_rhand"] = lanes(extra.get("rhand", hand0))
            frozen_keys += ["lhand", "rhand"]
        body = self._static(("body", L), **data)
        frozen = {k: body["frozen_" + k] for k in frozen_keys}
        anchor = ((body["anchor_w"], body["pose_init"], body["orient_init"],
                   self.pose_key) if config.temporal_weight > 0.0 else None)
        p = {
            "global_orient": (torch.cat([orient_a, orient_b]) if both
                              else orient_a),
            "betas": lanes(betas0),
            "cam_t": lanes(cam_t0),
        }
        if nj in (52, 55):
            p["lhand"] = lanes(extra.get("lhand", hand0))
            p["rhand"] = lanes(extra.get("rhand", hand0))
        if nj == 55:
            if config.optim_jaw:
                p["jaw"] = lanes(extra.get(
                    "jaw", torch.zeros(N, 3, device=dev)))
            if fam.n_expr:
                p["expression"] = lanes(extra.get(
                    "expression", torch.zeros(N, fam.n_expr, device=dev)))
        p[self.pose_key] = lanes(pose0)
        for k in frozen:
            p.pop(k, None)

        def body_loss(q, w):
            return self.shared_loss({**q, **frozen}, w, body["gt2d"],
                                    body["conf"], body["center"], anchor)

        loss = None
        for s in range(self.n_stages):
            res = self.opt.minimize(functools.partial(body_loss,
                                                      w=self.ws[s]), p,
                                    maxiters_op=stage_iters[s],
                                    stats=stage_stats,
                                    graph=self._graph_key(("body", L, s)))
            p, loss = res.params, res.loss
        e2 = self._mark()
        self._events = (e0, e1, e2)

        if both:
            l_a, l_b = loss[:N], loss[N:]
            use_b = allow_flip & (l_b < l_a)
            p = {k: torch.where(use_b.reshape((N,) + (1,) * (v.dim() - 1)),
                                v[N:], v[:N]) for k, v in p.items()}
            loss = torch.where(use_b, l_b, l_a)
        p = {**p, **{k: v[:N].clone() for k, v in frozen.items()}}
        with torch.no_grad():
            if config.use_vposer:
                body = vposer_lib.decode_to_axis_angle(
                    self.decoder, p["pose_embedding"]).reshape(N, -1)
                if body.shape[1] < self.body_dim:   # SMPL: zero joints 22/23
                    body = torch.cat([body, torch.zeros(
                        N, self.body_dim - body.shape[1], device=dev)], 1)
            else:
                body = p["body_pose"].reshape(N, self.body_dim)
            parts = [p["global_orient"].reshape(N, 3), body]
            if nj == 55:
                parts += [p["jaw"].reshape(N, 3) if "jaw" in p
                          else torch.zeros(N, 3, device=dev),
                          torch.zeros(N, 6, device=dev)]  # eyes: identity
            if nj in (52, 55):
                parts += [
                    _hand_aa(p, "lhand", self.hand_bases[0]).reshape(N, 45),
                    _hand_aa(p, "rhand", self.hand_bases[1]).reshape(N, 45),
                ]
            pose = torch.cat(parts, dim=1)
        return {
            "pose": pose, "shape": p["betas"], "cam_t": p["cam_t"],
            "emb": p["pose_embedding"] if "pose_embedding" in p
            else torch.zeros(N, 32, device=dev),
            "loss": loss,
            "expression": p["expression"] if "expression" in p
            else torch.zeros(N, max(fam.n_expr, 1), device=dev),
        }

    def _budgets(self, cam_maxiters=None, stage_maxiters=None):
        cam = self.config.maxiters if cam_maxiters is None \
            else int(cam_maxiters)
        if stage_maxiters is None:
            stages = [self.config.maxiters] * self.n_stages
        else:
            stages = np.broadcast_to(np.asarray(stage_maxiters, np.int64),
                                     (self.n_stages,)).tolist()
        return cam, stages

    def apply(self, kps, centers, init_t=None, has_init=None,
              betas0=None, pose0=None, orient0=None, anchor_w=None,
              cam_maxiters=None, stage_maxiters=None, mesh=None):
        """Tensor entry: batched (N, ...) tensors in -> dict of (N, ...)
        tensors on the device ({"pose", "shape", "cam_t", "emb", "loss",
        "expression"}); the serving step calls it.  ``mesh``: see the
        class docstring."""
        dev = self.device

        def on(x, shape, dtype=torch.float32):
            if x is None:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return torch.as_tensor(x, device=dev).to(dtype)

        kps = on(kps, None)
        B = kps.shape[0]
        inputs = [kps, on(centers, None), on(init_t, (B, 3)),
                  on(has_init, (B,), torch.bool), on(betas0, (B, 10)),
                  on(pose0, (B, self.pose_dim)), on(orient0, (B, 3)),
                  on(anchor_w, (B,))]
        cam_it, stage_it = self._budgets(cam_maxiters, stage_maxiters)
        if mesh is not None:
            return self._fit_sharded(inputs, cam_it, stage_it, mesh)
        return self._fit(*inputs, cam_it, stage_it)

    def __call__(self,
                 keypoints: np.ndarray,          # (N, 67, 3)
                 camera_centers: np.ndarray,     # (N, 2) or (2,)
                 init_cam_t: Optional[np.ndarray] = None,   # (N, 3)
                 init_params: Optional[dict] = None,        # N-leading
                 anchor_weight: Optional[np.ndarray] = None,  # (N,)
                 cam_maxiters: Optional[int] = None,
                 stage_maxiters=None,            # scalar or (n_stages,)
                 mesh=None) -> FitBatchOutput:
        kps = np.asarray(keypoints, np.float32)
        N = kps.shape[0]
        centers_np = np.broadcast_to(
            np.asarray(camera_centers, np.float32), (N, 2)).copy()
        if init_cam_t is None:
            init_t = np.zeros((N, 3), np.float32)
            has_init = np.zeros((N,), bool)
        else:
            init_t = np.asarray(init_cam_t, np.float32).reshape(N, 3)
            has_init = np.ones((N,), bool)
        # Per-frame warm starts (SPIN-style regress-then-optimize): any
        # entry absent from init_params falls back to zeros.
        ip = {k: np.asarray(v, np.float32)
              for k, v in (init_params or {}).items()}
        inputs = [kps, centers_np, init_t, has_init,
                  ip.get("betas", np.zeros((N, 10), np.float32)),
                  ip.get(self.pose_key,
                         np.zeros((N, self.pose_dim), np.float32)),
                  ip.get("global_orient", np.zeros((N, 3), np.float32)),
                  (np.zeros((N,), np.float32) if anchor_weight is None
                   else np.asarray(anchor_weight, np.float32).reshape(N))]
        dev = self.device
        t = [torch.as_tensor(x, device=dev) for x in inputs]
        cam_it, stage_it = self._budgets(cam_maxiters, stage_maxiters)
        out = (self._fit(*t, cam_it, stage_it) if mesh is None
               else self._fit_sharded(t, cam_it, stage_it, mesh))
        out = {k: _np(v) for k, v in out.items()}
        return FitBatchOutput(
            pose=out["pose"], shape=out["shape"],
            camera_translation=out["cam_t"], camera_center=centers_np,
            camera_fx=self.config.focal_length,
            pose_embedding=out["emb"], loss=out["loss"],
            expression=(out["expression"] if self.n_expr else None))


def fit_frame(
    model: params_lib.BodyModelParams,      # 52-joint SMPLH or 24-joint SMPL
    keypoints: np.ndarray,                  # (67, 3) x, y, conf (25 for SMPL)
    camera_center: np.ndarray,              # (2,)
    config: FitConfig = FitConfig(),
    dec_params=None,
    seed: int = 0,
    init_cam_t: Optional[np.ndarray] = None,
    init_params: Optional[dict] = None,
    device: DeviceLike = "cuda",
) -> FitOutput:
    """Fit SMPLH (or SMPL / SMPL-X) parameters to one frame's keypoints.

    ``init_cam_t`` overrides the limb-ratio depth heuristic with an
    external camera estimate; ``init_params`` optionally seeds any of
    ``global_orient`` (3,), ``betas`` (10,), ``pose_embedding`` (32,) /
    ``body_pose``, ``lhand``/``rhand``, ``jaw``, ``expression``.  The
    flipped orientation is fitted only where try_both_orient or the
    side-view shoulder test asks for it (decided on the host)."""
    fitter = BatchFitter(model, config, dec_params=dec_params, seed=seed,
                         device=device)
    dev = fitter.device
    kps = np.asarray(keypoints, np.float32)
    ip = {k: torch.as_tensor(np.asarray(v, np.float32),
                             device=dev).reshape(1, -1)
          for k, v in (init_params or {}).items()}
    gt2d = kps[:, :2]
    shoulder = float(np.linalg.norm(gt2d[2] - gt2d[5]))
    both = config.try_both_orient or shoulder < config.side_view_thsh
    if init_cam_t is None:
        init_t, has_init = torch.zeros(1, 3, device=dev), False
    else:
        init_t, has_init = torch.as_tensor(
            np.asarray(init_cam_t, np.float32), device=dev).reshape(1, 3), \
            True
    zeros = {"betas": 10, fitter.pose_key: fitter.pose_dim,
             "global_orient": 3}
    init = {k: ip.get(k, torch.zeros(1, n, device=dev))
            for k, n in zeros.items()}
    cam_it, stage_it = fitter._budgets()
    out = fitter._fit(
        torch.as_tensor(kps, device=dev)[None],
        torch.as_tensor(np.asarray(camera_center, np.float32),
                        device=dev).reshape(1, 2),
        init_t, torch.tensor([has_init], device=dev), init["betas"],
        init[fitter.pose_key], init["global_orient"],
        torch.zeros(1, device=dev), cam_it, stage_it,
        extra={k: v for k, v in ip.items()
               if k in ("lhand", "rhand", "jaw", "expression")},
        both=both)
    out = {k: _np(v)[0] for k, v in out.items()}
    return FitOutput(
        pose=out["pose"], shape=out["shape"],
        camera_translation=out["cam_t"], camera_rotation=np.eye(3),
        camera_center=np.asarray(camera_center),
        camera_fx=config.focal_length,
        pose_embedding=out["emb"], loss=float(out["loss"]),
        expression=(out["expression"] if fitter.n_expr else None))


def fit_frames(
    model: params_lib.BodyModelParams,
    keypoints: np.ndarray,           # (N, 67, 3)
    camera_centers: np.ndarray,      # (N, 2) or (2,)
    config: FitConfig = FitConfig(),
    dec_params=None,
    seed: int = 0,
    init_cam_t: Optional[np.ndarray] = None,   # (N, 3)
    init_params: Optional[dict] = None,        # leading N axis per entry
    mesh=None,
    device: DeviceLike = "cuda",
) -> FitBatchOutput:
    """Batched SMPLify: fit N frames as lanes of one :class:`BatchFitter`
    call (both orientation candidates of every frame evaluated, the flip
    selected per frame).  ``mesh=`` (``dist.mesh``) shards the frames over
    devices (:class:`BatchFitter`)."""
    fitter = BatchFitter(model, config, dec_params=dec_params, seed=seed,
                         device=device)
    return fitter(keypoints, camera_centers, init_cam_t=init_cam_t,
                  init_params=init_params, mesh=mesh)


def trim_frames(out: FitBatchOutput, n: int) -> FitBatchOutput:
    """The first ``n`` frames of a batch output, field by field (the
    per-frame fields by name; camera_fx is shared)."""
    return out._replace(**{f: getattr(out, f)[:n] for f in FRAME_FIELDS
                           if getattr(out, f) is not None})


def fit_sequence(
    model: params_lib.BodyModelParams,
    keypoints_seq: np.ndarray,       # (T, 67, 3)
    camera_centers: np.ndarray,      # (T, 2) or (2,)
    config: FitConfig = FitConfig(),
    dec_params=None,
    seed: int = 0,
    chained: bool = True,
    mesh=None,
    block: int = 1,
    device: DeviceLike = "cuda",
) -> FitBatchOutput:
    """Video fitting: T keypoint frames -> per-frame SMPLH fits.

    ``chained=True`` (default): frames warm-start from the previous
    solution (camera, orientation, shape, pose).  ``block=B`` fits B frames
    per batched call, all warm-started from the previous block's last
    solution; warm-started blocks run the truncated budgets
    ``warm_maxiters`` / ``warm_cam_maxiters``.  A short tail block is
    padded with copies of its last frame and trimmed by field.
    ``chained=False``: all frames fit independently in one batch, sharded
    over ``mesh`` when one is given (the chained fit does not use it, as
    in ``tpubody``)."""
    kps = np.asarray(keypoints_seq, np.float32)
    T = kps.shape[0]
    centers = np.broadcast_to(
        np.asarray(camera_centers, np.float32), (T, 2))
    fitter = BatchFitter(model, config, dec_params=dec_params, seed=seed,
                         device=device)
    if not chained:
        return fitter(kps, centers, mesh=mesh)
    pose_key = fitter.pose_key
    step = max(1, int(block))
    outs = []
    prev: Optional[FitBatchOutput] = None
    for s in range(0, T, step):
        kb = kps[s:s + step]
        cb = centers[s:s + step]
        n_real = kb.shape[0]
        if n_real < step:
            kb = np.concatenate(
                [kb, np.repeat(kb[-1:], step - n_real, axis=0)])
            cb = np.concatenate(
                [cb, np.repeat(cb[-1:], step - n_real, axis=0)])
        n = kb.shape[0]
        ip = ict = aw = cam_it = stage_it = None
        if prev is not None:
            def rep(a):
                return np.repeat(np.asarray(a)[-1:], n, axis=0)

            ip = {
                "global_orient": rep(prev.pose[:, :3]),
                "betas": rep(prev.shape),
                pose_key: rep(prev.pose_embedding if config.use_vposer
                              else prev.pose[:, 3:3 + fitter.body_dim]),
            }
            ict = rep(prev.camera_translation)
            aw = np.full((n,), config.temporal_weight, np.float32)
            # warm_cam_maxiters=0 inherits the previous camera; a block
            # inherits ONE camera for all its lanes, so block mode keeps
            # the camera stage running at the warm budget.
            if config.warm_maxiters is not None:
                cam_it = (config.warm_cam_maxiters if step == 1
                          else (config.warm_cam_maxiters
                                or config.warm_maxiters))
                stage_it = config.warm_maxiters
        prev = fitter(kb, cb, init_cam_t=ict, init_params=ip,
                      anchor_weight=aw, cam_maxiters=cam_it,
                      stage_maxiters=stage_it)
        if n_real < n:   # drop the tail block's padding lanes
            prev = trim_frames(prev, n_real)
        outs.append(prev)
    return FitBatchOutput(
        pose=np.concatenate([o.pose for o in outs]),
        shape=np.concatenate([o.shape for o in outs]),
        camera_translation=np.concatenate(
            [o.camera_translation for o in outs]),
        camera_center=np.concatenate([o.camera_center for o in outs]),
        camera_fx=config.focal_length,
        pose_embedding=np.concatenate([o.pose_embedding for o in outs]),
        loss=np.concatenate([o.loss for o in outs]),
        expression=(np.concatenate([o.expression for o in outs])
                    if outs[0].expression is not None else None),
    )
