"""Camera models: pinhole projection, weak perspective, translation fitting.

Port of ``tpubody.render.camera``:
  * pinhole world->pixel with the reference's extrinsic convention
    ``x_cam = R @ (x_world + T)`` (utils/J_render.py:44-113 JRender),
  * perspective projection with rotation/translation as used by the
    fitting camera (lib/Gen_SMPLH/camera.py:42-117, utils/geometry.py:63-91),
  * weak-perspective HMR camera (s, tx, ty) -> translation,
  * ``estimate_translation``: weighted least-squares camera translation from
    2D/3D joint correspondences (utils/geometry.py:94-157), solved in closed
    form on the 3x3 normal equations.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def _f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Intrinsics(NamedTuple):
    fx: torch.Tensor  # scalar
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, device=None):
        return cls(*(torch.as_tensor(v, dtype=torch.float32, device=device)
                     for v in (fx, fy, cx, cy)))


def world_to_cam(points: torch.Tensor, R: torch.Tensor,
                 T: torch.Tensor) -> torch.Tensor:
    """``x_cam = R @ (x + T)`` — the JRender extrinsic convention
    (utils/J_render.py:49-63).  points (..., N, 3), R (3,3), T (3,)."""
    return torch.einsum("ij,...nj->...ni", R, points + T)


def cam_to_pixel(points_cam: torch.Tensor, K: Intrinsics) -> torch.Tensor:
    """Perspective divide + intrinsics: (..., N, 3) -> (..., N, 2) pixels."""
    z = points_cam[..., 2:3]
    z = torch.where(z.abs() < 1e-8,
                    torch.sign(z) * 1e-8 + (z == 0).to(z.dtype) * 1e-8, z)
    u = points_cam[..., 0:1] / z * K.fx + K.cx
    v = points_cam[..., 1:2] / z * K.fy + K.cy
    return torch.cat([u, v], dim=-1)


def project_points(
    points: torch.Tensor,
    K: Intrinsics,
    R: Optional[torch.Tensor] = None,
    T: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full pinhole world->pixel projection (JRender __call__ parity)."""
    if R is None:
        R = torch.eye(3, dtype=points.dtype, device=points.device)
    if T is None:
        T = torch.zeros(3, dtype=points.dtype, device=points.device)
    return cam_to_pixel(world_to_cam(points, R, T), K)


def perspective_projection(
    points: torch.Tensor,       # (B, N, 3)
    rotation: torch.Tensor,     # (B, 3, 3)
    translation: torch.Tensor,  # (B, 3)
    focal_length,               # scalar or (B,)
    camera_center: torch.Tensor,  # (B, 2)
) -> torch.Tensor:
    """Batch perspective projection with the SMPLify convention
    ``x_cam = R @ x + t`` (utils/geometry.py:63-91, camera.py:104-117)."""
    pts = torch.einsum("bij,bnj->bni", rotation, points) \
        + translation[:, None, :]
    z = pts[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=pts.dtype,
                        device=pts.device).expand(z.shape[:1])
    uv = pts[..., :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z + 1e-30)
    uv = uv * f[:, None, None]
    return uv + camera_center[:, None, :]


def weak_perspective_translation(
    cam: torch.Tensor, focal_length: float, img_size: float
) -> torch.Tensor:
    """HMR weak-perspective (s, tx, ty) -> full translation (tx, ty, tz)
    with tz = 2f / (img_size * s) (the HMR/SPIN convention)."""
    s = torch.clamp(cam[..., 0], min=1e-6)
    tz = 2.0 * focal_length / (img_size * s)
    return torch.stack([cam[..., 1], cam[..., 2], tz], dim=-1)


def crop_cam_to_orig(
    cam: torch.Tensor,       # (..., 3) weak-persp (s, tx, ty) in the crop
    center,                  # (..., 2) crop center in original pixels
    scale,                   # (...,) HMR scale (crop side = 200*scale px)
    focal_length: float,
    img_center,              # (2,) original-image principal point
) -> torch.Tensor:
    """HMR weak-perspective cam predicted on a ``scale_and_crop`` window ->
    full-image perspective translation (tx, ty, tz) for a pinhole camera
    with ``focal_length`` centered at ``img_center`` (the SPIN
    convert_crop_cam_to_orig_img convention):
    tz = f / (100*scale*s),  T_xy = t_xy + (center - img_center)*tz/f.
    """
    cam = _f32(cam)
    s = torch.clamp(cam[..., 0], min=1e-6)
    scale = _f32(scale, cam)
    tz = focal_length / (100.0 * scale * s)
    off = (_f32(center, cam) - _f32(img_center, cam)) \
        * tz[..., None] / focal_length
    return torch.stack([cam[..., 1] + off[..., 0],
                        cam[..., 2] + off[..., 1], tz], dim=-1)


def estimate_translation(
    joints3d: torch.Tensor,   # (N, 3)
    joints2d: torch.Tensor,   # (N, 2) pixels
    conf: torch.Tensor,       # (N,) confidence weights
    focal_length: float,
    img_center: torch.Tensor,  # (2,)
) -> torch.Tensor:
    """Weighted least-squares camera translation: for each joint the
    projection constraint is linear in (tx, ty, tz); the 3x3 normal
    equations are formed and solved (utils/geometry.py:94-157 redesign)."""
    x3, y3, z3 = joints3d[:, 0], joints3d[:, 1], joints3d[:, 2]
    u = joints2d[:, 0] - img_center[0]
    v = joints2d[:, 1] - img_center[1]
    f = focal_length
    # Rows: f*(x3+tx) = u*(z3+tz)  ->  f*tx - u*tz = u*z3 - f*x3
    #       f*(y3+ty) = v*(z3+tz)  ->  f*ty - v*tz = v*z3 - f*y3
    zero = torch.zeros_like(u)
    A = torch.cat([
        torch.stack([torch.full_like(u, f), zero, -u], dim=-1),
        torch.stack([zero, torch.full_like(v, f), -v], dim=-1),
    ], dim=0)                                    # (2N, 3)
    b = torch.cat([u * z3 - f * x3, v * z3 - f * y3], dim=0)  # (2N,)
    w = torch.cat([conf, conf], dim=0)
    AtA = A.t() @ (A * w[:, None])
    Atb = A.t() @ (b * w)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA + 1e-8 * eye, Atb)


class OrthoCamera(NamedTuple):
    """Orthographic-frustum camera matching the opendr renderer setup
    (utils/render_model.py:17-61): vertices are already in image-plane
    coordinates after a rigid transform + scale; rasterization uses x,y as
    pixels and z for depth ordering."""

    scale: torch.Tensor     # scalar pixels-per-unit
    center: torch.Tensor    # (2,) pixel center
    flip_y: bool = False

    def to_screen(self, verts: torch.Tensor) -> torch.Tensor:
        """(..., V, 3) world -> (..., V, 3) screen (x_pix, y_pix, depth)."""
        xy = verts[..., :2] * self.scale + self.center
        if self.flip_y:
            xy = torch.stack([xy[..., 0], -xy[..., 1]], dim=-1)
        return torch.cat([xy, verts[..., 2:3]], dim=-1)
