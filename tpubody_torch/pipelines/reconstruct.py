"""End-to-end single-image reconstruction pipeline (reference main.py;
port of ``tpubody.pipelines.reconstruct``).

Stages (call stack parity with main.py:28-141):
  1. SMPLH forward at the fitted (shape, pose156): models.smpl,
  2. project SMPL joints to pixels: render.camera (JRender math),
  3. render front/back normal + 24-weight value maps: render.bodymaps,
  4. warp the maps into the photo silhouette: image.warp,
  5. integrate normals to front/back depth: solve.normal2depth,
  6. stitch the two depth meshes + recover 3D joints: mesh.stitch,
  7. rig the mesh onto the SMPL skeleton: mesh.rigging.

Stages 1-5 run on the device :func:`reconstruct` is given (the card
unless the caller asks for the CPU).  Their outputs cross to the host
once; stitch, rig, the optional hand graft and the export then run on the
host in numpy (with the C++ host-geometry helper), apart from the few
small torch calls they make on the same device: the silhouette's closing
in stitch and the SMPL forwards of rig and the hand graft.

With ``cache=True`` every stage persists the reference's side-car
artifacts (smplh_value.npy, warp_and_filled.npy, depth_front.npy, ...
main.py:84-122) through the content-addressed StageCache, giving
resumable runs.  With ``cache=False`` the intermediate blocks stay
DEVICE-resident (the 126 MB value block never round-trips the host) and
only what stitch consumes is pulled.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.image import warp as warp_lib
from tpubody_torch.mesh import gltf as gltf_lib
from tpubody_torch.mesh import hands as hands_lib
from tpubody_torch.mesh import meshio, rigging, stitch as stitch_lib
from tpubody_torch.models import params as params_lib
from tpubody_torch.models import smpl as smpl_lib
from tpubody_torch.render import bodymaps, camera as camera_lib
from tpubody_torch.solve import normal2depth as n2d
from tpubody_torch.utils.cache import StageCache, digest
from tpubody_torch.utils.profiling import StageTimer


class FitResult(NamedTuple):
    """Contents of the fitting stage's smplh.pkl
    (data/tests/*/smplh.pkl schema)."""

    shape: np.ndarray              # (10,)
    pose: np.ndarray               # (156,) SMPLH axis-angle (52*3)
    camera_center: np.ndarray      # (2,)
    camera_rotation: np.ndarray    # (3, 3)
    camera_translation: np.ndarray  # (3,)
    camera_fx: float


def load_fit_pickle(path: str) -> FitResult:
    """Read a fit pickle.  Unpickling runs code: read only files this
    program (or the fitting stage you trust) wrote."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="iso-8859-1")
    return FitResult(
        shape=np.asarray(d["spmlh_shape"], np.float64).reshape(-1)[:10],
        pose=np.asarray(d["spmlh_pose"], np.float64).reshape(-1),
        camera_center=np.asarray(d["camera_center"], np.float64).reshape(2),
        camera_rotation=np.asarray(d["camera_rotation"],
                                   np.float64).reshape(3, 3),
        camera_translation=np.asarray(d["camera_translation"],
                                      np.float64).reshape(3),
        camera_fx=float(np.asarray(d.get("camera_fx", 5000.0)).reshape(-1)[0]),
    )


def save_fit_pickle(path: str, fit: FitResult) -> None:
    with open(path, "wb") as f:
        pickle.dump({
            "spmlh_shape": fit.shape, "spmlh_pose": fit.pose,
            "camera_center": fit.camera_center,
            "camera_rotation": fit.camera_rotation,
            "camera_translation": fit.camera_translation,
            "camera_fx": fit.camera_fx,
        }, f)


class ReconstructResult(NamedTuple):
    avatar: rigging.RiggedAvatar
    points: np.ndarray     # stitched (N, 30) attribute mesh
    faces: np.ndarray
    joints3d: np.ndarray


def result_from_numpy(result) -> ReconstructResult:
    """The port's :class:`ReconstructResult` from ``tpubody``'s (the same
    fields: numpy arrays and an avatar, converted by
    :func:`tpubody_torch.mesh.rigging.avatar_from_numpy`)."""
    return ReconstructResult(
        avatar=rigging.avatar_from_numpy(**result.avatar._asdict()),
        points=result.points, faces=result.faces, joints3d=result.joints3d)


def _device_stages(
    mask: np.ndarray,
    fit: FitResult,
    smplh_model: params_lib.BodyModelParams,
    smpl_model: params_lib.BodyModelParams,
    sc: StageCache,
    timer: StageTimer,
    detail: Optional[StageTimer],
    keep: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stages 1-5 on the models' device -> (J_2d (24, 2) int pixels,
    stitch weights (H, W, 24), front depth, back depth (H, W)), all numpy.

    ``sc.enabled`` selects the cached branch (every stage's artifact goes
    through the host and the cache) or the device-resident one.  A dict
    passed as ``keep`` receives the intermediates a check wants to look at:
    ``value`` and ``warp`` (the rendered and the warped (H, W, 30) maps, as
    the branch holds them) and ``pcg`` (the solve's iterations and relative
    residual; empty on a cache hit)."""
    dev = smplh_model.device
    mask = np.asarray(mask)
    H, W = mask.shape

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    def sub(name):
        return detail.stage(name) if detail else contextlib.nullcontext()

    pose_h = fit.pose.reshape(-1, 3)[:smplh_model.num_joints]
    pose_b = pose_h[:24]

    with timer.stage("smplh_forward"):
        verts = smpl_lib.forward(smplh_model, f32(pose_h),
                                 f32(fit.shape)).verts
        state_b = smpl_lib.forward(smpl_model, f32(pose_b), f32(fit.shape))

    with timer.stage("project_joints"):
        K = camera_lib.Intrinsics.make(
            fit.camera_fx, fit.camera_fx,
            fit.camera_center[0], fit.camera_center[1], device=dev)
        J3d_smpl = smpl_lib.regress_joints(smpl_model, state_b.verts)
        J_2d = camera_lib.project_points(
            J3d_smpl, K, f32(fit.camera_rotation),
            f32(fit.camera_translation)).cpu().numpy()
        J_2d = np.clip(np.round(J_2d), 0, [W - 1, H - 1]).astype(int)

    with timer.stage("render_value_maps"):
        def _render_dev():
            with sub("render/device"):
                return bodymaps.render_body_maps(
                    verts, smplh_model.faces, smpl_model.weights,
                    fit.camera_translation, fit.camera_center,
                    H, W, focal=fit.camera_fx, device=dev).value

        if sc.enabled:
            h_val = digest(verts.cpu().numpy().astype(np.float64),
                           smpl_model.weights.cpu().numpy(),
                           fit.camera_translation, fit.camera_center,
                           H=H, W=W)
            maps = sc.run(
                "render", h_val, ["smplh_value.npy"],
                lambda: {"smplh_value.npy": _render_dev().cpu().numpy()})
            smplh_value = maps["smplh_value.npy"]
        else:
            # Cache off: the 30-channel value block (126 MB at 1024^2)
            # stays DEVICE-resident through warp and normal2depth; only
            # what stitch consumes crosses to the host.
            smplh_value = _render_dev()

    mask_dev = torch.as_tensor(mask > 0, device=dev)
    with timer.stage("warp"):
        if sc.enabled:
            h_warp = digest(smplh_value, mask)

            def _warp():
                v = warp_lib.warp_stage(mask, smplh_value, timer=detail,
                                        device=dev).value
                with sub("warp/to_host"):
                    return {"warp_and_filled.npy": v.cpu().numpy()}

            warped = sc.run("warp", h_warp, ["warp_and_filled.npy"], _warp)
            warp_value = warped["warp_and_filled.npy"]
            stitch_weights = warp_value[..., 6:]
        else:
            warp_dev = warp_lib.warp_stage(mask, smplh_value, timer=detail,
                                           device=dev).value

    with timer.stage("normal2depth"):
        stats = {}
        if sc.enabled:
            h_n2d = digest(warp_value[..., :6], mask)
            names = ["depth_front.npy", "depth_back.npy"]
            depths = sc.run(
                "normal2depth", h_n2d, names,
                lambda: dict(zip(names, [x.cpu().numpy() for x in
                                         n2d.normal2depth(
                                             f32(warp_value[..., :6]),
                                             mask_dev, stats=stats)])))
            front_depth, back_depth = (depths[n] for n in names)
        else:
            fd, bd = n2d.normal2depth(warp_dev[..., :6], mask_dev,
                                      stats=stats)
            # Stitch consumes only the 24 weight channels, and blend
            # weights in [0,1] lose nothing that survives the rig stage's
            # renormalization at f16: 50 MB crosses the host boundary
            # instead of the full 126 MB f32 block.
            with sub("warp/to_host"):
                stitch_weights = warp_dev[..., 6:].to(torch.float16).cpu() \
                    .numpy().astype(np.float32)
            front_depth = fd.cpu().numpy()
            back_depth = bd.cpu().numpy()
    if keep is not None:
        keep.update(value=smplh_value,
                    warp=warp_value if sc.enabled else warp_dev, pcg=stats)
    return J_2d, stitch_weights, front_depth, back_depth


def _host_stages(
    front_rgb: np.ndarray,
    back_rgb: np.ndarray,
    fit: FitResult,
    smpl_model: params_lib.BodyModelParams,
    J_2d: np.ndarray,
    stitch_weights: np.ndarray,
    front_depth: np.ndarray,
    back_depth: np.ndarray,
    sc: StageCache,
    save: bool,
    replace_hands: bool,
    timer: StageTimer,
    detail: Optional[StageTimer],
) -> ReconstructResult:
    """Stages 6-7 and the export on the host, from the device stages'
    numpy outputs: stitch (its mask closing on the model's device), rig
    (its SMPL forwards there too), the optional hand graft, and with
    ``save`` the side-cars, the avatar pickle, ``out.ply`` and ``out.glb``
    through ``sc``."""
    dev = smpl_model.device
    pose_b = fit.pose.reshape(-1, 3)[:24]
    with timer.stage("stitch"):
        fc = np.asarray(front_rgb, np.float32)[..., :3]
        bc = np.asarray(back_rgb, np.float32)[..., :3]
        res = stitch_lib.stitch_mesh(
            front_depth, fc, back_depth, bc,
            stitch_weights, J_2d, timer=detail, device=dev)
        if save:
            np.save(sc.path("points"), res.points)
            np.save(sc.path("faces"), res.faces)
            np.save(sc.path("J_3d"), res.joints3d)

    with timer.stage("rig"):
        avatar = rigging.rig_mesh(
            smpl_model,
            res.points[:, :3], res.points[:, 3:6], res.faces,
            res.points[:, 6:30], pose_b, fit.shape, res.joints3d)

    if replace_hands:
        with timer.stage("replace_hands"):
            avatar = hands_lib.replace_hands(avatar, smpl_model)

    if save:
        with timer.stage("save"):
            rigging.save_avatar(
                sc.path("replace_hands_recover.pkl" if replace_hands
                        else "or_recover.pkl"), avatar)
            meshio.write_ply(sc.path("out.ply"), res.points[:, :3],
                             res.faces, res.points[:, 3:6])
            # Engine-ready skinned export of the rigged avatar alongside
            # the pickle (beyond the reference's PLY/pickle-only surface).
            gltf_lib.export_avatar_glb(sc.path("out.glb"), avatar)
    return ReconstructResult(avatar=avatar, points=res.points,
                             faces=res.faces, joints3d=res.joints3d)


def reconstruct(
    front_rgb: np.ndarray,        # (H, W, 3) uint8/float
    back_rgb: np.ndarray,
    mask: np.ndarray,             # (H, W) person silhouette
    fit: FitResult,
    smplh_model: params_lib.BodyModelParams,   # 52-joint model
    smpl_model: params_lib.BodyModelParams,    # 24-joint model (weights/J)
    out_dir: Optional[str] = None,
    replace_hands: bool = False,
    cache: bool = True,
    timer: Optional[StageTimer] = None,
    device: DeviceLike = "cuda",
) -> ReconstructResult:
    """Run the reconstruction (main.py:28-141 parity) on ``device``: the
    card unless the caller passes ``device="cpu"``; raises where CUDA is
    asked for and there is none.  The body models are moved there.

    With ``out_dir`` the stitched mesh's side-cars (``points.npy``,
    ``faces.npy``, ``J_3d.npy``), the avatar pickle (``or_recover.pkl``,
    or ``replace_hands_recover.pkl`` with the hand graft), ``out.ply`` and
    ``out.glb`` are written there; with the cache on, the device stages'
    artifacts too."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if smplh_model.device != dev:
        smplh_model = smplh_model.to(dev)
    if smpl_model.device != dev:
        smpl_model = smpl_model.to(dev)
    timer = timer or StageTimer()
    # TPUBODY_DETAIL=1: substage attribution (each substage then ends in a
    # device synchronisation; measurement mode only).
    detail = timer if os.environ.get("TPUBODY_DETAIL") else None
    if out_dir:
        sc = StageCache(out_dir, enabled=cache)
        cleanup = contextlib.nullcontext()
    else:
        import tempfile

        cleanup = tempfile.TemporaryDirectory(prefix="tpubody_cache_")
        sc = StageCache(cleanup.name, enabled=False)
    with cleanup:
        J_2d, stitch_weights, front_depth, back_depth = _device_stages(
            mask, fit, smplh_model, smpl_model, sc, timer, detail)

    return _host_stages(front_rgb, back_rgb, fit, smpl_model, J_2d,
                        stitch_weights, front_depth, back_depth, sc,
                        bool(out_dir), replace_hands, timer, detail)


def load_test_dir(path: str):
    """Load a reference fixture directory (data/tests/testNN layout) ->
    (front RGB, back RGB, mask, FitResult).  The fit pickle is unpickled:
    read only directories this program, or a fitting stage you trust,
    wrote."""
    import cv2

    from tpubody_torch.image import ops as img_ops
    front = img_ops.read_image(os.path.join(path, "front_rgb.png"))
    back = img_ops.read_image(os.path.join(path, "back_rgb.png"))
    mask = cv2.imread(os.path.join(path, "mask.png"), cv2.IMREAD_GRAYSCALE)
    if mask is None:
        raise FileNotFoundError(
            f"unreadable image: {os.path.join(path, 'mask.png')}")
    fit = load_fit_pickle(os.path.join(path, "smplh.pkl"))
    return front, back, mask, fit
