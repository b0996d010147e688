"""SPIN-style regress-then-optimize: HMR warm-starts SMPLify (port of
``tpubody.pipelines.refine``).

The HMR regressor predicts (pose rotmats, shape, weak-persp camera) from
the image crop in one forward pass; those predictions become the fit's
parameterization (full-image perspective camera translation through
``render.camera.crop_cam_to_orig``, axis-angle body pose, optionally a
VPoser latent through the encoder), and the staged SMPLify refines from
there instead of from zero.

Batched end to end: N images -> one HMR forward -> one batch of fit lanes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpubody_torch.core.rotations import rotmat_to_axis_angle
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.fit import keypoints as kp_lib
from tpubody_torch.fit import smplify
from tpubody_torch.models import params as params_lib
from tpubody_torch.render import camera as camera_lib


def keypoint_crop_params(keypoints: np.ndarray, pad: float = 1.2):
    """(67, 3) keypoints -> (center (2,), HMR scale) of the person bbox
    (scale is side/200 like image.ops.scale_and_crop)."""
    kp = np.asarray(keypoints)
    valid = kp[:, 2] > 0
    pts = kp[valid, :2] if valid.any() else kp[:, :2]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (lo + hi) / 2.0
    side = max(float((hi - lo).max()), 1.0) * pad
    return center, side / 200.0


def hmr_init_from_images(
    predictor,
    img_paths: Sequence[str],
    keypoints: np.ndarray,          # (N, 67, 3)
    img_centers: np.ndarray,        # (N, 2) principal points (W/2, H/2)
    config: smplify.FitConfig,
    encoder=None,
):
    """Run HMR on keypoint-centered crops and convert its predictions into
    fit_frames inits: (init_cam_t (N, 3), init_params dict).  ``encoder``
    is a VPoserEncoder (a seeded one would be a worse start than the
    prior mean, so without one the embedding stays zero)."""
    centers, scales = [], []
    for i in range(len(img_paths)):
        c, s = keypoint_crop_params(keypoints[i])
        centers.append(c)
        scales.append(s)
    centers = np.asarray(centers, np.float32)
    scales = np.asarray(scales, np.float32)

    pred = predictor.from_files(img_paths, centers=centers, scales=scales)
    init_cam_t = camera_lib.crop_cam_to_orig(
        pred.cam.float().cpu(), centers, scales, config.focal_length,
        img_centers).numpy()

    # HMR predicts SMPL rotmats: joint 0 = global orient, 1..21 = the
    # shared body chain, 22/23 = SMPL's wrist-level hands.  The SMPLH fit
    # seeds its 63-dim body pose from 1..21; a model_type='smpl' fit takes
    # the full 69-dim 1..23 seed.
    aa = rotmat_to_axis_angle(pred.rotmats.float().cpu()).numpy()
    n = len(img_paths)
    init_params = {
        "global_orient": aa[:, 0],
        "betas": pred.shape.float().cpu().numpy(),
    }
    body63 = aa[:, 1:22].reshape(n, 63).astype(np.float32)
    if config.use_vposer:
        if encoder is not None:
            with torch.no_grad():
                dev = next(encoder.parameters()).device
                mu, _ = encoder(torch.as_tensor(body63, device=dev))
            init_params["pose_embedding"] = mu.cpu().numpy()
    elif config.model_type == "smpl":
        init_params["body_pose"] = aa[:, 1:24].reshape(n, 69).astype(
            np.float32)
    else:
        init_params["body_pose"] = body63
    return init_cam_t, init_params


def refine(
    items,                           # [(img, keyp, out_dir), ...]
    model: Optional[params_lib.BodyModelParams] = None,
    config: Optional[smplify.FitConfig] = None,
    config_yaml: Optional[str] = None,
    vposer_ckpt: Optional[str] = None,
    predictor=None,
    hmr_ckpt: Optional[str] = None,
    save_artifacts: bool = True,
    mesh=None,
    device: DeviceLike = "cuda",
):
    """images + keypoints -> HMR warm start -> batched SMPLify -> the full
    per-dir artifact set (conf.yaml, smplh.pkl, pre_smplh.pkl, smplh.obj,
    overlay PNG).  Returns FitResults in input order.  ``mesh``
    (``dist.mesh``) shards the frames of the fit over its devices."""
    import os

    import cv2

    from tpubody_torch.fit import vposer as vposer_lib
    from tpubody_torch.pipelines import gen_smplh as gen_lib
    from tpubody_torch.pipelines import hmr_infer

    dev = resolve(device)
    config = config or gen_lib.load_config(config_yaml)
    if model is None:
        model = gen_lib.default_fit_model(config, device=dev)
    gen_lib.check_model_family(model, config)
    if predictor is None:
        predictor = hmr_infer.HMRPredictor(
            focal_length=config.focal_length, device=dev)
        if hmr_ckpt:
            predictor.load_torch_checkpoint(hmr_ckpt)

    decoder = encoder = None
    ckpt = vposer_ckpt or gen_lib.DEFAULT_VPOSER_CKPT
    if config.use_vposer and ckpt and os.path.exists(ckpt):
        decoder, encoder = vposer_lib.load_torch_checkpoint(ckpt, device=dev)

    imgs, kps, img_centers = [], [], []
    for img_path, keyp_path, _ in items:
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(f"unreadable image: {img_path}")
        H, W = img.shape[:2]
        imgs.append(img)
        img_centers.append([W / 2.0, H / 2.0])
        kps.append(kp_lib.read_openpose_json(
            keyp_path, use_hands=gen_lib._hands(config),
            use_face=gen_lib._face(config),
            use_face_contour=config.use_face_contour).keypoints)
    kps = np.stack(kps).astype(np.float32)
    img_centers = np.asarray(img_centers, np.float32)

    init_cam_t, init_params = hmr_init_from_images(
        predictor, [it[0] for it in items], kps, img_centers, config,
        encoder=encoder)

    batch = smplify.fit_frames(
        model, kps, img_centers, config, dec_params=decoder,
        init_cam_t=init_cam_t, init_params=init_params, mesh=mesh,
        device=dev)
    return gen_lib.save_batch_fit_results(items, batch, imgs, model, config,
                                          save_artifacts=save_artifacts,
                                          device=dev)
