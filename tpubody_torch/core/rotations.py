"""Rotation representations on tensors with arbitrary leading batch dims.

Port of ``tpubody.core.rotations``: the same formulas, epsilon placement
and column conventions, so both packages agree to fp32 rounding.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3).

    ``r == 0`` maps to the identity (squared-norm epsilon guard)."""
    sq = torch.sum(r * r, dim=-1, keepdim=True)
    theta = torch.sqrt(sq + _EPS)
    k = r / theta  # unit axis
    cos = torch.cos(theta)[..., None]
    sin = torch.sin(theta)[..., None]

    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    # Cross-product (skew) matrix K of the unit axis.
    K = torch.stack(
        [
            torch.stack([zeros, -kz, ky], dim=-1),
            torch.stack([kz, zeros, -kx], dim=-1),
            torch.stack([-ky, kx, zeros], dim=-1),
        ],
        dim=-2,
    )
    outer = k[..., :, None] * k[..., None, :]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(outer.shape)
    return cos * eye + (1.0 - cos) * outer + sin * K


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z), not necessarily normalised, (..., 4) ->
    rotation matrices (..., 3, 3)."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (wy + xz),
            2 * (wz + xy), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (wx + yz), ww - xx - yy + zz,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion (w, x, y, z)."""
    theta = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True) + _EPS)
    half = theta * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * (r / theta)], dim=-1)


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    # rsqrt(sum^2 + eps) instead of norm().clamp(): finite gradient at 0.
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + _EPS)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (..., 6) -> rotation matrices (..., 3, 3)
    by Gram-Schmidt.  The 6 numbers are the first two *columns* of the
    matrix, read as ``x.reshape(..., 3, 2)``."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = _safe_normalize(a1)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _safe_normalize(a2 - proj * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> 6D representation (inverse of
    :func:`rot6d_to_rotmat`)."""
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> quaternions (w, x, y, z), branch-free
    Shepperd/Markley max-trace selection, canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def _safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=_EPS))

    # Four candidate constructions, each stable in a different region.
    qw0 = _safe_sqrt(1.0 + m00 + m11 + m22) * 0.5
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], dim=-1)

    qx1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 0.5
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)

    qy2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 0.5
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)

    qz3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 0.5
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)

    trace = m00 + m11 + m22
    cond0 = (trace > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rotmat_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> axis-angle vectors."""
    q = rotmat_to_quat(R)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    axis = xyz / torch.clamp(sin_half, min=_EPS)
    return axis * theta
