"""Self-supervised pose-detector training from the framework's own renderer
(port of ``tpubody.pipelines.pose_train``).

Random bodies are posed (torch-op LBS), shaded (the fragment rasterizer
of ``render.video.render_frame``) and their joints projected with the
same camera, producing unlimited (image, keypoints) supervision for the
detector of ``models/pose2d.py`` with no external data.

The synthesizer is split in two: :meth:`Synthesizer.draw` makes every
random draw (poses, betas, colours, the world rotation, camera jitter,
the coarse background, photometric gains, occluders) on the CPU from an
explicit ``torch.Generator``, so a seed gives the same data on every
device, and :meth:`Synthesizer.render` turns the draws into a batch on
the body's device, deterministically (tests feed it ``tpubody``'s
draws).  ``tpubody`` runs fixed-length ``lax.scan`` chunks; the port runs
one Python-loop step at a time with the same chunk semantics (see
:func:`train_pose2d_synthetic`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.models import params as params_lib
from tpubody_torch.models import pose2d
from tpubody_torch.models import smpl as smpl_lib
from tpubody_torch.render import video as video_lib

# The render path (video.render_frame / project_like_render) applies the
# reference's -pi/2 x pre-rotation (model2video.py:300-309), which maps
# world +y onto the optical axis — a y-up standing body would be viewed
# top-down.  Pre-rotating by +pi/2 about x cancels it: the image is then a
# standard pinhole looking down +z at the y-up body, and pose/rotation
# labels stay in plain world coordinates.
_R_UP = np.array([[1.0, 0.0, 0.0],
                  [0.0, 0.0, -1.0],
                  [0.0, 1.0, 0.0]])
BG_GRID = 6              # coarse background samples per side


def project_like_render(points: torch.Tensor, cam_t: torch.Tensor,
                        focal: float, height: int, width: int
                        ) -> torch.Tensor:
    """Project (..., 3) world points with render_frame's exact camera
    (pre-rotation, flip-YZ, pinhole) so joint labels align with pixels;
    ``cam_t`` broadcasts against ``points``."""
    pre = torch.as_tensor(video_lib._PRE_ROT.T, dtype=points.dtype,
                          device=points.device)
    flip = torch.as_tensor(video_lib._FLIP_YZ.T, dtype=points.dtype,
                           device=points.device)
    v = (points @ pre + cam_t) @ flip
    z = torch.clamp(-v[..., 2:3], min=1e-6)
    x = v[..., 0:1] / z * focal + width / 2.0
    y = -v[..., 1:2] / z * focal + height / 2.0
    return torch.cat([x, y, torch.ones_like(z)], dim=-1)


def cubic_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize(..., "cubic")`` along
    one axis: Keys' cubic with a = -0.5 (``F.interpolate``'s bicubic uses
    -0.75), half-pixel centres, taps outside the input dropped and the
    rest renormalised, no antialiasing (this is for upsampling)."""
    scale = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None])
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.as_tensor(np.where(inside[None, :], w, 0.0).T,
                           dtype=torch.float32)


def _yaw_pitch_roll(gen: torch.Generator, batch: int, yaw_scale: float,
                    tilt_scale: float) -> torch.Tensor:
    """(batch, 3, 3) rotations: uniform yaw, small gaussian pitch/roll."""
    yaw = yaw_scale * (torch.rand(batch, generator=gen) * 2 - 1) * math.pi
    pitch = tilt_scale * torch.randn(batch, generator=gen)
    roll = tilt_scale * torch.randn(batch, generator=gen)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    Ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    Rx = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(-1, 3, 3)
    Rz = torch.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(-1, 3, 3)
    return Ry @ Rx @ Rz


class SynthDraws(NamedTuple):
    """Every random draw of one synthesized batch (float32, CPU)."""

    poses: torch.Tensor      # (B, J, 3) axis-angle body pose
    betas: torch.Tensor      # (10,) shared shape
    colors: torch.Tensor     # (V, 3) vertex colours
    R: torch.Tensor          # (B, 3, 3) world rotation (identity if plain)
    dz: torch.Tensor         # (B, 1) camera depth jitter, x cam_z
    dxy: torch.Tensor        # (B, 2) image-plane offset
    coarse: torch.Tensor     # (B, 6, 6, 3) low-frequency background
    bright: torch.Tensor     # (B, 1, 1, 1)
    contr: torch.Tensor      # (B, 1, 1, 1)
    gain: torch.Tensor       # (B, 1, 1, 3)
    occ_cxy: torch.Tensor    # (n_occluders, B, 2) centre (row, column)
    occ_wh: torch.Tensor     # (n_occluders, B, 2) half-extents
    occ_col: torch.Tensor    # (n_occluders, B, 1, 1, 3)


class SynthBatch(NamedTuple):
    images: torch.Tensor     # (B, S, S, 3) in [0,1]
    keypoints: torch.Tensor  # (B, J, 3) pixel x, y, valid
    poses: torch.Tensor      # (B, J, 3) axis-angle body pose
    betas: torch.Tensor      # (10,) shared shape
    global_R: torch.Tensor   # (B, 3, 3) domain-rand world rotation


class Synthesizer:
    """``synth(gen, batch) -> SynthBatch``: draws on the CPU generator
    ``gen``, renders on the body's device (see the module docstring).

    ``domain_rand=True`` adds the randomizations that matter for transfer:
    uniform global yaw + small pitch/roll, camera depth/offset jitter,
    low-frequency textured backgrounds, photometric jitter, and random
    occluding rectangles (keypoints under an occluder keep valid=1)."""

    def __init__(self, body, size: int = 64, focal: float = 150.0,
                 cam_z: Optional[float] = None, pose_scale: float = 0.25,
                 window: int = 64, domain_rand: bool = False,
                 n_occluders: int = 2):
        self.body = body
        self.size, self.focal, self.window = size, focal, window
        self.pose_scale = pose_scale
        self.domain_rand = domain_rand
        self.n_occluders = n_occluders
        dev = body.device
        self.faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.int32,
                                     device=dev)
        # Auto-framing in the (post-cancellation) camera frame: centre the
        # subject and pick a depth that fits its whole extent (with
        # pose-variation margin) in ~70% of the crop.
        v0 = body.v_template.detach().cpu().double().numpy()
        center0 = (v0.min(axis=0) + v0.max(axis=0)) / 2.0
        self.extent = float((v0.max(axis=0) - v0.min(axis=0))[:2].max()) \
            * 1.35
        depth_half = float(v0[:, 2].max() - v0[:, 2].min()) * 0.75 + 0.05
        if cam_z is None:
            cam_z = max(self.extent * focal / (0.70 * size), 1e-3) \
                + depth_half
        self.cam_z = cam_z
        self.base_t = torch.tensor([-center0[0], -center0[1],
                                    cam_z - center0[2]], dtype=torch.float32,
                                   device=dev)
        self.r_up = torch.as_tensor(_R_UP.T, dtype=torch.float32, device=dev)
        self.resize = cubic_resize_matrix(BG_GRID, size).to(dev)

    def draw(self, gen: torch.Generator, batch: int) -> SynthDraws:
        J, V, n_occ = self.body.num_joints, self.body.num_verts, \
            self.n_occluders
        poses = self.pose_scale * torch.randn(batch, J, 3, generator=gen)
        colors = 0.4 + 0.5 * torch.rand(V, 3, generator=gen)
        if not self.domain_rand:
            z = torch.zeros
            return SynthDraws(
                poses, z(10), colors, torch.eye(3).expand(batch, 3, 3),
                z(batch, 1), z(batch, 2), z(batch, BG_GRID, BG_GRID, 3),
                z(batch, 1, 1, 1), torch.ones(batch, 1, 1, 1),
                torch.ones(batch, 1, 1, 3), z(0, batch, 2), z(0, batch, 2),
                z(0, batch, 1, 1, 3))
        betas = 0.5 * torch.randn(10, generator=gen)
        R = _yaw_pitch_roll(gen, batch, 1.0, 0.15)
        dz = torch.rand(batch, 1, generator=gen) * 0.7 - 0.25
        dxy = 0.07 * self.extent * torch.randn(batch, 2, generator=gen)
        coarse = torch.rand(batch, BG_GRID, BG_GRID, 3, generator=gen)
        bright = 0.15 * torch.randn(batch, 1, 1, 1, generator=gen)
        contr = 1.0 + 0.25 * torch.randn(batch, 1, 1, 1, generator=gen)
        gain = 1.0 + 0.12 * torch.randn(batch, 1, 1, 3, generator=gen)
        occ_cxy = self.size * torch.rand(n_occ, batch, 2, generator=gen)
        occ_wh = self.size * (0.05 + 0.17 * torch.rand(n_occ, batch, 2,
                                                       generator=gen))
        occ_col = torch.rand(n_occ, batch, 1, 1, 3, generator=gen)
        return SynthDraws(poses, betas, colors, R, dz, dxy, coarse, bright,
                          contr, gain, occ_cxy, occ_wh, occ_col)

    def render(self, d: SynthDraws) -> SynthBatch:
        dev = self.body.device
        d = SynthDraws(*[torch.as_tensor(x, dtype=torch.float32).to(dev)
                         for x in d])
        batch, size = d.poses.shape[0], self.size
        state = smpl_lib.forward_batch(self.body, d.poses, d.betas, None)
        verts, joints = state.verts, state.joints_posed
        if self.domain_rand:
            # Global orientation: rotate verts+joints about the body center.
            Rt = d.R.transpose(1, 2)
            center = verts.mean(dim=1, keepdim=True)
            verts = (verts - center) @ Rt + center
            joints = (joints - center) @ Rt + center
            cam_t = self.base_t + torch.cat([d.dxy, self.cam_z * d.dz], -1)
            bg = torch.einsum("yi,bijc,xj->byxc", self.resize, d.coarse,
                              self.resize)
        else:
            cam_t = self.base_t.expand(batch, 3)
            bg = torch.full((batch, size, size, 3), 0.15, device=dev)

        verts = verts @ self.r_up
        joints = joints @ self.r_up
        imgs = torch.stack([
            video_lib.render_frame(verts[i], self.faces, d.colors, cam_t[i],
                                   bg[i], height=size, width=size,
                                   focal=self.focal, window=self.window)
            for i in range(batch)])
        kps = project_like_render(joints, cam_t[:, None, :], self.focal,
                                  size, size)

        if self.domain_rand:
            # Photometric jitter, then occluding rectangles (labels
            # unchanged: the net must learn amodal localization).
            imgs = (imgs - 0.5) * d.contr * d.gain + 0.5 + d.bright
            yy = torch.arange(size, dtype=torch.float32,
                              device=dev)[None, :, None]
            xx = torch.arange(size, dtype=torch.float32,
                              device=dev)[None, None, :]
            for cxy, wh, col in zip(d.occ_cxy, d.occ_wh, d.occ_col):
                inside = ((torch.abs(yy - cxy[:, 0:1, None])
                           < wh[:, 0:1, None])
                          & (torch.abs(xx - cxy[:, 1:2, None])
                             < wh[:, 1:2, None]))
                imgs = torch.where(inside[..., None], col, imgs)
            imgs = torch.clamp(imgs, 0.0, 1.0)

        inside = ((kps[..., 0] >= 0) & (kps[..., 0] < size)
                  & (kps[..., 1] >= 0) & (kps[..., 1] < size))
        kps = torch.cat([kps[..., :2], inside[..., None].to(kps.dtype)], -1)
        return SynthBatch(images=imgs, keypoints=kps, poses=d.poses,
                          betas=d.betas, global_R=d.R)

    def __call__(self, gen: torch.Generator, batch: int) -> SynthBatch:
        return self.render(self.draw(gen, batch))


# tpubody's name for the constructor: ``make_synthesizer(body, size=...)``.
make_synthesizer = Synthesizer


class PoseTrainResult(NamedTuple):
    model: Any
    params: Any
    losses: np.ndarray
    pixel_err_before: float
    pixel_err_after: float


@torch.no_grad()
def _pixel_err(model, data: SynthBatch) -> float:
    pred = pose2d.detect(model, data.images).keypoints.cpu().numpy()
    gt = data.keypoints.cpu().numpy()
    valid = gt[..., 2] > 0
    d = np.linalg.norm(pred[..., :2] - gt[..., :2], axis=-1)
    return float(d[valid].mean()) if valid.any() else float("nan")


def train_pose2d_synthetic(
    steps: int = 50,
    batch: int = 8,
    size: int = 64,
    n_joints: int = 24,
    n_verts: int = 1200,    # enough for the capsule humanoid's min res
    features: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    body=None,
    domain_rand: bool = False,
    init_params=None,
    on_chunk: Optional[Callable[[Any, int], None]] = None,
    chunk: int = 100,
    device: DeviceLike = "cuda",
) -> PoseTrainResult:
    """Train a pose2d detector purely on rendered synthetic bodies.

    ``init_params`` (a state_dict) resumes from an earlier run's weights;
    ``on_chunk(state_dict, steps_done)`` is called after every chunk of
    ``chunk`` steps — the CLI uses it for periodic checkpointing.  As in
    ``tpubody``, every chunk runs ``chunk`` steps: the last one may run up
    to ``chunk - 1`` steps past ``steps``, which are not in ``losses``, and
    ``steps_done`` counts them."""
    dev = resolve(device)
    if body is None:
        # Structured capsule humanoid when the budget allows: humanlike
        # silhouettes and limb keypoint semantics.
        try:
            from tpubody_torch.models import humanoid as humanoid_lib

            body = humanoid_lib.humanoid(n_joints=n_joints, n_verts=n_verts,
                                         seed=seed, device=dev)
        except ValueError:
            body = params_lib.synthetic(n_joints=n_joints, n_verts=n_verts,
                                        seed=seed, device=dev)
    synth = make_synthesizer(body, size=size, domain_rand=domain_rand)
    model = pose2d.create_pose2d(n_keypoints=body.num_joints,
                                 features=features, device=dev)
    if init_params is not None:
        model.load_state_dict(init_params)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = pose2d.make_train_step(model, opt)

    gen = torch.Generator(device="cpu").manual_seed(seed)
    eval_batch = synth(gen, batch)
    err0 = _pixel_err(model, eval_batch)

    chunk = min(steps, max(1, int(chunk)))
    losses = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        chunk_losses = []
        for _ in range(chunk):
            data = synth(gen, batch)
            chunk_losses.append(step(data.images, data.keypoints))
        losses.extend(torch.stack(chunk_losses[:n]).cpu().tolist())
        done += chunk
        if on_chunk is not None:
            on_chunk(model.state_dict(), done)
    err1 = _pixel_err(model, eval_batch)
    return PoseTrainResult(model=model, params=model.state_dict(),
                           losses=np.asarray(losses),
                           pixel_err_before=err0, pixel_err_after=err1)
