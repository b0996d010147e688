"""Asset-free end-to-end demo: self-generated fixture -> full pipeline
(port of ``tpubody.pipelines.demo``).

The reference ships golden fixture directories (data/tests/testNN: front
and back photos, silhouette mask, OpenPose keypoints, fitted smplh.pkl +
conf.yaml) whose binary body models are stripped from the public
checkout.  This module regenerates the same layout from the capsule
humanoid (models/humanoid.py) — a posed, shaded render becomes the
"photo", its silhouette the mask, its projected joints the keypoints,
and its true pose/camera the fit pickle — so the complete
fit -> reconstruct -> rig -> hand-graft -> animate -> glTF chain runs
with zero external assets, on the card unless the caller asks for the
CPU:

    python -m tpubody_torch.cli demo out/            # fixture + reconstruction
    python -m tpubody_torch.cli reconstruct out/     # fixtures are reusable

Provenance: fixture layout per data/tests/test01; camera/posing
conventions per lib/Gen_SMPLH/camera.py:104-117 and
utils/render_model.py:32-33.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve


def demo_pose(n_joints: int = 52, seed: int = 0) -> np.ndarray:
    """A natural-looking deterministic pose: photo-convention global flip
    (fits of upright photos land at global_orient ~ [pi,0,0]), relaxed
    arms, slight knee bend, small seeded jitter."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((n_joints, 3))
    pose[0] = [np.pi, 0.0, 0.0]          # upright in image coordinates
    # Arms slightly below T-pose but well clear of the torso (a deeply
    # lowered arm merges with the body silhouette and defeats the
    # depth-map arm reconstruction, like a real A-pose-against-body photo
    # would).
    pose[16] = [0.0, 0.0, -0.22]         # shoulders
    pose[17] = [0.0, 0.0, 0.22]
    pose[18] = [0.0, 0.0, -0.12]         # elbows
    pose[19] = [0.0, 0.0, 0.12]
    pose[4] = [0.08, 0.0, 0.0]           # knees
    pose[5] = [0.08, 0.0, 0.0]
    pose[1:22] += rng.normal(scale=0.015, size=(21, 3))
    return pose


# Demo body shape: girth +2.5 (humanoid shapedirs mode 1) fattens the
# limbs so forearms stay several pixels wide — thin limbs fall below the
# depth-map resolution at demo image sizes and reconstruct as fragments.
DEMO_BETAS = np.array([0.0, 2.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)


def make_fixture(out_dir: str, size: int = 256, verts: int = 3000,
                 seed: int = 0, betas: Optional[np.ndarray] = None,
                 device: DeviceLike = "cuda") -> Tuple[object, object]:
    """Write a reference-layout fixture dir (front_rgb.png, back_rgb.png,
    mask.png, 0_keypoints.json, smplh.pkl, conf.yaml) rendered from the
    humanoid on ``device``.  Returns the (smplh, smpl) humanoid models used,
    on that device."""
    import cv2

    from tpubody_torch.fit import joints as joints_lib
    from tpubody_torch.fit import keypoints as kp_lib
    from tpubody_torch.models import humanoid as humanoid_lib
    from tpubody_torch.models import smpl as smpl_lib
    from tpubody_torch.pipelines import gen_smplh as gen_lib
    from tpubody_torch.pipelines import reconstruct as rec
    from tpubody_torch.render import bodymaps

    dev = resolve(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    os.makedirs(out_dir, exist_ok=True)
    smplh = humanoid_lib.humanoid(52, verts, seed=seed, device=dev)
    smpl = humanoid_lib.humanoid(24, verts, seed=seed, device=dev)

    betas = DEMO_BETAS if betas is None else np.asarray(betas, np.float64)
    pose = demo_pose(52, seed)
    state = smpl_lib.forward(smplh, f32(pose), f32(betas))
    v = state.verts.cpu().numpy()

    # Reference-scale intrinsics (fx 5000 at 1024^2), camera centered on
    # the posed body with a margin (fit projection convention: x + t).
    focal = 5000.0 * size / 1024.0
    center = np.array([size / 2.0, size / 2.0])
    c = (v.min(axis=0) + v.max(axis=0)) / 2.0
    extent = float((v.max(axis=0) - v.min(axis=0))[:2].max()) * 1.35
    cam_z = extent * focal / (0.85 * size)
    cam_t = np.array([-c[0], -c[1], cam_z - c[2]])

    screen = bodymaps.project_to_screen(f32(v), f32(cam_t), f32(center),
                                        focal)

    # Skin-ish vertical color gradient as the "photo" appearance.
    y01 = (v[:, 1] - v[:, 1].min()) / max(float(np.ptp(v[:, 1])), 1e-6)
    colors = np.stack([0.80 - 0.25 * y01, 0.62 - 0.25 * y01,
                       0.52 - 0.20 * y01], axis=1)

    s2 = screen.cpu().numpy()[:, :2]
    tri = s2[np.asarray(smplh.faces)]
    ext = float((tri.max(axis=1) - tri.min(axis=1)).max())
    window = int(min(max(np.ceil(ext * 1.05 / 8) * 8 + 8, 16), 256))
    img, mask = bodymaps._render_channels(
        screen, torch.as_tensor(np.asarray(smplh.faces), device=dev),
        f32(colors), size, size, window, 0.86)
    front = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    back = front[:, ::-1].copy()         # photographed from behind
    mask_u8 = (mask.cpu().numpy() > 0).astype(np.uint8) * 255

    cv2.imwrite(os.path.join(out_dir, "front_rgb.png"), front[:, :, ::-1])
    cv2.imwrite(os.path.join(out_dir, "back_rgb.png"), back[:, :, ::-1])
    cv2.imwrite(os.path.join(out_dir, "mask.png"), mask_u8)

    j_op = joints_lib.openpose_joints(
        state.verts, state.joints_posed).cpu().numpy()
    cam = j_op + cam_t
    kp = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-6) * focal + center
    kp3 = np.concatenate([kp, np.ones((kp.shape[0], 1))], axis=1)
    kp_lib.write_openpose_json(
        os.path.join(out_dir, "0_keypoints.json"),
        kp3[:25], kp3[25:46], kp3[46:67])

    fit = rec.FitResult(
        shape=betas, pose=pose.reshape(-1),
        camera_center=center, camera_rotation=np.eye(3),
        camera_translation=cam_t, camera_fx=focal)
    rec.save_fit_pickle(os.path.join(out_dir, "smplh.pkl"), fit)
    gen_lib.dump_config(os.path.join(out_dir, "conf.yaml"),
                        gen_lib.load_config(None, focal_length=focal))
    return smplh, smpl


def run_demo(out_dir: str, size: int = 256, verts: int = 3000,
             seed: int = 0, fit: bool = False,
             animate_frames: int = 8,
             fit_config=None, device: DeviceLike = "cuda") -> dict:
    """Generate the fixture, optionally re-fit it from its own keypoints,
    reconstruct with hand grafting, animate a short clip, and export a
    skinned GLB, all on ``device``.  Returns {artifact name: path}."""
    from tpubody_torch.io import motion as motion_lib
    from tpubody_torch.mesh import gltf as gltf_lib
    from tpubody_torch.pipelines import animate as animate_lib
    from tpubody_torch.pipelines import gen_smplh as gen_lib
    from tpubody_torch.pipelines import reconstruct as rec

    dev = resolve(device)
    smplh, smpl = make_fixture(out_dir, size=size, verts=verts, seed=seed,
                               device=dev)
    arts = {name: os.path.join(out_dir, name)
            for name in ("front_rgb.png", "back_rgb.png", "mask.png",
                         "0_keypoints.json", "smplh.pkl", "conf.yaml")}

    if fit:
        # Refit from the generated keypoints (overwrites smplh.pkl with
        # the optimizer's solution + the reference's side artifacts).
        config = fit_config or gen_lib.load_config(
            None, focal_length=5000.0 * size / 1024.0)
        gen_lib.gen_smplh(arts["front_rgb.png"], arts["0_keypoints.json"],
                          out_dir, model=smplh, config=config, device=dev)
        arts["pre_smplh.pkl"] = os.path.join(out_dir, "pre_smplh.pkl")
        arts["smplh2rgb_rend.png"] = os.path.join(out_dir,
                                                  "smplh2rgb_rend.png")

    front, back, mask, fitres = rec.load_test_dir(out_dir)
    res = rec.reconstruct(front, back, mask, fitres, smplh, smpl,
                          out_dir=out_dir, replace_hands=True, device=dev)
    arts["replace_hands_recover.pkl"] = os.path.join(
        out_dir, "replace_hands_recover.pkl")
    arts["out.ply"] = os.path.join(out_dir, "out.ply")

    if animate_frames:
        t = np.linspace(0.0, np.pi, animate_frames)
        poses = np.zeros((animate_frames, 24, 3))
        poses[:, 16, 2] = -0.5 - 0.5 * np.sin(t)     # wave the left arm
        poses[:, 18, 2] = -0.3 * np.sin(t)
        ext = float(np.ptp(np.asarray(res.avatar.v_template),
                           axis=0).max())
        mp4 = animate_lib.animate_video(
            res.avatar,
            motion_lib.MotionClip(poses=poses,
                                  trans=np.zeros((animate_frames, 3)),
                                  fps=12.0),
            os.path.join(out_dir, "demo.mp4"),
            cam_t=np.asarray([0.0, 0.0, 2.2 * ext]),
            size=min(size, 256), device=dev)
        arts["demo.mp4"] = mp4

    gltf_lib.export_avatar_glb(os.path.join(out_dir, "avatar.glb"),
                               res.avatar)
    arts["avatar.glb"] = os.path.join(out_dir, "avatar.glb")
    return arts
