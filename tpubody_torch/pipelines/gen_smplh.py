"""Fitting pipeline: image + OpenPose keypoints -> smplh.pkl (port
of ``tpubody.pipelines.gen_smplh``).

Capability parity with the reference SMPLify entry script
(lib/gen_smplh.py:34-191): load YAML-layered config, read the image and
keypoint JSON, run the staged fitting, dump the resolved config
(conf.yaml) and the result pickle (smplh.pkl, through
``reconstruct.save_fit_pickle``) next to the outputs, with the side
artifacts pre_smplh.pkl, smplh.obj and smplh2rgb_rend.png.

The VPoser snapshot is read from ``vposer_ckpt`` or the
``TPUBODY_VPOSER_CKPT`` environment variable (the reference's
TR00_E096.pt); without one the fit runs on the seeded decoder.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.fit import keypoints as kp_lib
from tpubody_torch.fit import smplify
from tpubody_torch.fit import vposer as vposer_lib
from tpubody_torch.models import params as params_lib
from tpubody_torch.pipelines import reconstruct as rec

DEFAULT_VPOSER_CKPT = os.environ.get("TPUBODY_VPOSER_CKPT", "")


# Reference config keys that do NOT map to FitConfig fields and are
# intentionally handled elsewhere or dead (smpl_config.py:14-272): IO paths
# and environment selection live in the CLI / gen_smplh arguments;
# use_cuda/float_dtype are not fit options (the device is an argument
# of the entry points and the fit runs in fp32).
_ACKNOWLEDGED_NON_FITCONFIG_KEYS = frozenset({
    # IO / environment (handled by gen_smplh arguments + model loading)
    "input_img_path", "input_keyp_path", "output_folder", "config",
    "vposer_ckpt", "model_folder", "part_segm_fn",
    "summary_folder", "use_cuda", "float_dtype", "interactive",
    "visualize", "save_meshes", "degrees", "dataset",
    "gender_lbl_type", "camera_type",
    "batch_size", "loss_type",
    # Hand-prior variants: the fit regularizes hand PCA coefficients with
    # L2 (see fit/smplify.py _make_body_loss); the MoG hand prior needs pickles
    # the reference does not ship.
    "left_hand_prior_type", "right_hand_prior_type",
    # BVH search internals with no dense-sweep analog: the mesh collision
    # term (fit/mesh_collision.py) evaluates ALL allowed pairs, so a BVH
    # pair cap / point2plane toggle has nothing to configure; part-pair
    # filtering is derived from the kinematic tree instead of an explicit
    # list.  df_cone_height IS mapped (→ coll_cone_scale, below).
    "max_collisions", "point2plane", "penalize_outside",
    "ign_part_pairs",
})


def load_config(yaml_path: Optional[str] = None,
                **overrides) -> smplify.FitConfig:
    """YAML-over-defaults config layering (reference parse_config,
    lib/Gen_SMPLH/smpl_config.py:14-272 + fit_smplh.yaml).

    Every YAML key whose name matches a FitConfig field lands on that
    field (full live-flag parity: optim_type, lr, data_weights, use_pca,
    num_pca_comps, interpenetration, coll_loss_weights, body_prior_type,
    side_view_thsh, ...).  Unknown keys outside the acknowledged
    environment/dead set raise so nothing is silently dropped.
    """
    cfg = {}
    if yaml_path and os.path.exists(yaml_path):
        import yaml

        # Reference conf.yaml dumps carry !!python/tuple tags
        # (gen_smplh.py:51-53 uses yaml.dump of parsed-args objects);
        # accept them without enabling arbitrary object construction.
        class _Loader(yaml.SafeLoader):
            pass

        _Loader.add_constructor(
            "tag:yaml.org,2002:python/tuple",
            lambda loader, node: tuple(loader.construct_sequence(node)))

        with open(yaml_path) as f:
            raw = yaml.load(f, Loader=_Loader) or {}

        fields = {f.name: f for f in dataclasses.fields(smplify.FitConfig)}
        unknown = []
        # Reference configs describe the BVH + distance-field collision
        # term (fitting.py:404-442); its equivalent here is the mesh
        # cone-field mode, so conf.yaml-driven fits default to it (the
        # programmatic FitConfig default stays the cheap sphere proxy).
        if raw.get("interpenetration") and "coll_mode" not in raw:
            cfg["coll_mode"] = "mesh"
        if "df_cone_height" in raw:
            # df_cone_height (smpl_config.py:216-219, default 0.5) scales
            # how deep the repulsive field reaches; calibrated so the
            # reference default lands on 2.0 circumradii.
            cfg["coll_cone_scale"] = float(raw["df_cone_height"]) * 4.0
        for key, v in raw.items():
            if key == "df_cone_height":
                continue
            if key not in fields:
                if key not in _ACKNOWLEDGED_NON_FITCONFIG_KEYS:
                    unknown.append(key)
                continue
            if key == "body_tri_idxs":
                # Accept both the dumped tuple-pairs form and the flat
                # CLI form [5, 12, 2, 9] (smpl_config.py body_tri_idxs).
                seq = [tuple(x) if isinstance(x, (list, tuple)) else x
                       for x in v]
                if seq and not isinstance(seq[0], tuple):
                    seq = [tuple(seq[i:i + 2]) for i in range(0, len(seq), 2)]
                cfg[key] = tuple(seq)
            elif key == "joints_to_ign" and not isinstance(v, (list, tuple)):
                # smpl_config.py default is the scalar -1 = "none".
                cfg[key] = () if v in (-1, None) else (int(v),)
            elif key == "jaw_pose_prior_weights" and v is not None:
                # Per-stage (pitch, yaw, roll) triples; the reference CLI
                # form is a list of '1,2,3' strings.
                cfg[key] = tuple(
                    tuple(float(x) for x in
                          (row.split(",") if isinstance(row, str) else row))
                    for row in v)
            elif isinstance(v, list):
                cfg[key] = tuple(v)
            else:
                cfg[key] = v
        if unknown:
            raise ValueError(
                f"conf.yaml keys not understood (would be silently "
                f"dropped): {sorted(unknown)}")
    cfg.update(overrides)
    # The fit core handles all three smpl_config.py:83-84 choices: smplh
    # (the reference's live configuration, fit_smplh.yaml:17), smpl
    # (24-joint body-only) and smplx (55-joint face+hands with
    # expression/jaw/face-landmark terms).
    mt = cfg.get("model_type", "smplh")
    if mt not in ("smpl", "smplh", "smplx"):
        raise ValueError(
            f"model_type={mt!r} is not a body family "
            "(smpl, smplh or smplx)")
    if cfg.get("gender", "male") not in ("neutral", "male", "female"):
        raise ValueError(f"gender={cfg['gender']!r} "
                         "(neutral, male or female; smpl_config.py:76-80)")
    out = smplify.FitConfig(**cfg)
    # Stage-schedule consistency for EXPLICITLY provided schedules (the
    # reference's fit_single_frame.py:110-147 asserts).  FitConfig itself
    # truncates untouched defaults to the stage count as a programmatic
    # convenience; here we know which keys the YAML/caller actually set,
    # so a mismatched explicit schedule is a config error, not a request
    # to silently drop entries.
    n_stages = len(out.body_pose_prior_weights)
    # Face/expression schedules only bind when they are live (the
    # reference's asserts sit under `if use_face` — its own fixture
    # conf.yamls carry 4-stage face/expr defaults beside 5-stage body
    # schedules with use_face off, fit_single_frame.py:110-147).
    checked = ["data_weights", "shape_weights", "hand_pose_prior_weights",
               "hand_joints_weights", "coll_loss_weights"]
    if out.model_type == "smplx":
        checked += ["expr_weights", "jaw_pose_prior_weights"]
        if out.use_face:
            checked += ["face_joints_weights"]
    for key in checked:
        if key in cfg and cfg[key] is not None \
                and len(cfg[key]) != n_stages:
            raise ValueError(
                f"{key} has {len(cfg[key])} entries but "
                f"body_pose_prior_weights defines {n_stages} stages "
                "(reference fit_single_frame.py:110-147 consistency "
                "asserts)")
    return out


_FAMILY_JOINTS = {"smpl": 24, "smplh": 52, "smplx": 55}


def _hands(config: smplify.FitConfig) -> bool:
    """Effective use_hands: SMPL (24-joint) has no articulated hands."""
    return config.use_hands and config.model_type in ("smplh", "smplx")


def _face(config: smplify.FitConfig) -> bool:
    """Effective use_face: only SMPL-X carries face landmarks."""
    return config.use_face and config.model_type == "smplx"


def default_fit_model(config: smplify.FitConfig,
                      device: DeviceLike = "cpu"):
    """Body model per config.model_type + config.gender: a real asset when
    present (params.default_model_path — gendered asset/env first, neutral
    fallback), synthetic — with the loud placeholder warning — otherwise."""
    kind = config.model_type
    n_verts = (params_lib.SMPLX_NUM_VERTS if kind == "smplx"
               else params_lib.SMPL_NUM_VERTS)
    return params_lib.load_or_synthetic(
        kind, n_joints=_FAMILY_JOINTS[kind], n_verts=n_verts, seed=0,
        gender=config.gender, device=device)


def check_model_family(model, config: smplify.FitConfig) -> None:
    """Fail at entry — not with a shape error deep inside the
    loss — when the body model's joint count contradicts
    config.model_type (e.g. a 24-joint model under the default smplh)."""
    want = _FAMILY_JOINTS[config.model_type]
    if model.num_joints != want:
        raise ValueError(
            f"model has {model.num_joints} joints but config.model_type="
            f"{config.model_type!r} expects {want}; pass a matching model "
            "or set model_type accordingly")


def dump_config(path: str, config: smplify.FitConfig) -> None:
    """Reproducibility: re-dump the resolved config next to the outputs
    (reference gen_smplh.py:51-53)."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(config).items()}, f)


def _decoder(config, vposer_ckpt, device, dec_params=None):
    """``dec_params`` when given, else the trained VPoser decoder when its
    snapshot exists, else None (the fit then seeds one)."""
    if dec_params is not None:
        return dec_params
    ckpt = vposer_ckpt or DEFAULT_VPOSER_CKPT
    if config.use_vposer and ckpt and os.path.exists(ckpt):
        dec, _ = vposer_lib.load_torch_checkpoint(ckpt, device=device)
        return dec
    return None


def _fit_result(out) -> rec.FitResult:
    return rec.FitResult(
        shape=out.shape, pose=out.pose,
        camera_center=out.camera_center,
        camera_rotation=out.camera_rotation,
        camera_translation=out.camera_translation,
        camera_fx=out.camera_fx)


def gen_smplh(
    img_path: str,
    keyp_path: str,
    out_path: str,
    model: Optional[params_lib.BodyModelParams] = None,
    config: Optional[smplify.FitConfig] = None,
    config_yaml: Optional[str] = None,
    vposer_ckpt: Optional[str] = None,
    save_artifacts: bool = True,
    dec_params=None,
    device: DeviceLike = "cuda",
) -> rec.FitResult:
    """Fit SMPLH to one image's keypoints; write conf.yaml + smplh.pkl
    (+ pre_smplh.pkl, smplh.obj, smplh2rgb_rend.png like the reference's
    fit_single_frame.py:440-521 when ``save_artifacts``).

    Multi-person images: up to ``config.max_persons`` detected people fit
    as lanes of one batch.  Person 0 writes the standard artifact names;
    person i writes ``smplh_p{i}.pkl`` (+ suffixed side-artifacts).
    Returns person 0's FitResult.  ``dec_params`` (a VPoserDecoder)
    replaces the VPoser snapshot."""
    import cv2
    dev = resolve(device)
    os.makedirs(out_path, exist_ok=True)
    config = config or load_config(config_yaml)
    dump_config(os.path.join(out_path, "conf.yaml"), config)

    img = cv2.imread(img_path)
    if img is None:
        raise FileNotFoundError(f"unreadable image: {img_path}")
    H, W = img.shape[:2]
    camera_center = np.array([W / 2.0, H / 2.0])

    n_people = min(kp_lib.num_people(keyp_path), max(1, config.max_persons))
    read = lambda i: kp_lib.read_openpose_json(  # noqa: E731
        keyp_path, person=i, use_hands=_hands(config),
        use_face=_face(config), use_face_contour=config.use_face_contour)

    if model is None:
        model = default_fit_model(config, device=dev)
    check_model_family(model, config)
    decoder = _decoder(config, vposer_ckpt, dev, dec_params)

    if n_people > 1:
        kps = np.stack([read(i).keypoints for i in range(n_people)])
        centers = np.broadcast_to(camera_center, (n_people, 2))
        batch = smplify.fit_frames(
            model, kps.astype(np.float32),
            np.ascontiguousarray(centers, np.float32), config,
            dec_params=decoder, device=dev)
        fits = save_batch_fit_results(
            [(img_path, keyp_path, out_path)], batch, [img], model, config,
            save_artifacts=save_artifacts,
            rows=[(0, p) for p in range(n_people)], device=dev)
        return fits[0]

    out = smplify.fit_frame(model, read(0).keypoints, camera_center,
                            config, dec_params=decoder, device=dev)
    fit = _fit_result(out)
    rec.save_fit_pickle(os.path.join(out_path, "smplh.pkl"), fit)
    if save_artifacts:
        _save_fit_artifacts(out_path, model, out, img, config, device=dev)
    return fit


def gen_smplh_batch(
    items,                                    # [(img, keyp, out_dir), ...]
    model: Optional[params_lib.BodyModelParams] = None,
    config: Optional[smplify.FitConfig] = None,
    config_yaml: Optional[str] = None,
    vposer_ckpt: Optional[str] = None,
    save_artifacts: bool = True,
    mesh=None,
    dec_params=None,
    device: DeviceLike = "cuda",
):
    """Fit MANY (image, keypoints) pairs as lanes of one batch, then write
    each directory's artifacts as the single-frame entry does.  Returns
    the FitResults of person 0 of each item, in input order.  ``mesh``
    (``dist.mesh``) shards the frames over its devices."""
    import cv2

    dev = resolve(device)
    config = config or load_config(config_yaml)
    if model is None:
        model = default_fit_model(config, device=dev)
    check_model_family(model, config)
    decoder = _decoder(config, vposer_ckpt, dev, dec_params)

    imgs, kps, centers, rows = [], [], [], []
    for idx, (img_path, keyp_path, out_dir) in enumerate(items):
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(f"unreadable image: {img_path}")
        H, W = img.shape[:2]
        imgs.append(img)
        n_people = min(kp_lib.num_people(keyp_path),
                       max(1, config.max_persons))
        for p in range(n_people):
            centers.append([W / 2.0, H / 2.0])
            kps.append(kp_lib.read_openpose_json(
                keyp_path, person=p, use_hands=_hands(config),
                use_face=_face(config),
                use_face_contour=config.use_face_contour).keypoints)
            rows.append((idx, p))

    batch = smplify.fit_frames(
        model, np.stack(kps).astype(np.float32),
        np.asarray(centers, np.float32), config, dec_params=decoder,
        mesh=mesh, device=dev)
    fits = save_batch_fit_results(items, batch, imgs, model, config,
                                  save_artifacts=save_artifacts, rows=rows,
                                  device=dev)
    return [fits[rows.index((i, 0))] for i in range(len(items))]


def _slice_batch_output(batch, i: int) -> smplify.FitOutput:
    """Frame ``i`` of a FitBatchOutput as a single-frame FitOutput."""
    return smplify.FitOutput(
        pose=batch.pose[i], shape=batch.shape[i],
        camera_translation=batch.camera_translation[i],
        camera_rotation=np.eye(3),
        camera_center=batch.camera_center[i],
        camera_fx=batch.camera_fx,
        pose_embedding=batch.pose_embedding[i],
        loss=float(batch.loss[i]),
        expression=(batch.expression[i]
                    if batch.expression is not None else None))


def save_batch_fit_results(items, batch, imgs, model, config,
                           save_artifacts: bool = True, rows=None,
                           device: DeviceLike = "cuda"):
    """Write each frame of a batched fit as the single-frame entry would:
    conf.yaml + smplh.pkl (+ pre_smplh.pkl / smplh.obj / overlay when
    ``save_artifacts``) per output dir.  ``rows``: one ``(item_idx,
    person_idx)`` per batch frame (default: frame i is person 0 of item
    i).  Returns one FitResult per batch frame, in batch order."""
    if rows is None:
        rows = [(i, 0) for i in range(len(items))]
    results = []
    for i, (idx, person) in enumerate(rows):
        out_dir = items[idx][2]
        os.makedirs(out_dir, exist_ok=True)
        if person == 0:
            dump_config(os.path.join(out_dir, "conf.yaml"), config)
        single = _slice_batch_output(batch, i)
        fit = _fit_result(single)
        suffix = "" if person == 0 else f"_p{person}"
        rec.save_fit_pickle(
            os.path.join(out_dir, f"smplh{suffix}.pkl"), fit)
        if save_artifacts:
            _save_fit_artifacts(out_dir, model, single, imgs[idx], config,
                                suffix=suffix, device=device)
        results.append(fit)
    return results


def _save_fit_artifacts(out_path: str,
                        model: params_lib.BodyModelParams,
                        out: smplify.FitOutput,
                        img: np.ndarray,
                        config: smplify.FitConfig,
                        suffix: str = "",
                        device: DeviceLike = "cuda") -> None:
    """Write the reference's fitting side-artifacts next to smplh.pkl
    (fit_single_frame.py:440-521): pre_smplh.pkl (raw best-orientation
    parameter dict), smplh.obj (fitted mesh, 180-degree x-flip as the
    reference's OpenGL convention), smplh2rgb_rend.png (fit rendered over
    the photo through the port's rasterizer)."""
    import pickle

    import torch

    from tpubody_torch.mesh import meshio
    from tpubody_torch.models import smpl as smpl_lib
    from tpubody_torch.render import viewer as viewer_lib

    dev = resolve(device)
    n_pose = len(out.pose)
    body_dim = 69 if n_pose == 72 else 63
    params = {
        "camera_translation": out.camera_translation,
        "camera_rotation": out.camera_rotation,
        "camera_center": out.camera_center,
        "betas": out.shape,
        "global_orient": out.pose[:3],
        "body_pose": (out.pose_embedding if config.use_vposer
                      else out.pose[3:3 + body_dim]),
        "loss": out.loss,
    }
    if n_pose == 156:               # SMPLH: articulated hands
        params["left_hand_pose"] = out.pose[66:111]
        params["right_hand_pose"] = out.pose[111:156]
    elif n_pose == 165:             # SMPL-X: jaw + eyes + hands
        params["jaw_pose"] = out.pose[66:69]
        params["leye_pose"] = out.pose[69:72]
        params["reye_pose"] = out.pose[72:75]
        params["left_hand_pose"] = out.pose[75:120]
        params["right_hand_pose"] = out.pose[120:165]
        if out.expression is not None:
            params["expression"] = out.expression
    with open(os.path.join(out_path, f"pre_smplh{suffix}.pkl"), "wb") as f:
        pickle.dump(params, f, protocol=2)

    fwd_model = model.to(dev)
    beta = np.asarray(out.shape, np.float32)
    if out.expression is not None and fwd_model.expr_dirs is not None:
        # Render/export with the fitted expression applied.
        n_expr = len(out.expression)
        fwd_model = dataclasses.replace(
            fwd_model, cache={}, shapedirs=torch.cat(
                [fwd_model.shapedirs, fwd_model.expr_dirs[:, :, :n_expr]],
                dim=-1))
        beta = np.concatenate([beta, np.asarray(out.expression, np.float32)])
    with torch.no_grad():
        state = smpl_lib.forward(
            fwd_model, torch.as_tensor(np.asarray(out.pose, np.float32),
                                       device=dev).reshape(-1, 3),
            torch.as_tensor(beta, device=dev))
    verts = state.verts.cpu().numpy()
    # 180-degree rotation about x (fit_single_frame.py:464-468).
    flipped = verts * np.array([1.0, -1.0, -1.0])
    meshio.write_obj(os.path.join(out_path, f"smplh{suffix}.obj"),
                     flipped, np.asarray(model.faces))

    viewer_lib.overlay_fit(
        img[..., ::-1] if img.ndim == 3 and img.shape[2] == 3 else img,
        verts, np.asarray(model.faces),
        out.camera_translation, out.camera_center,
        focal=float(out.camera_fx),
        out_path=os.path.join(out_path, f"smplh2rgb_rend{suffix}.png"),
        device=dev)
