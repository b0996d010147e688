"""Plain PyTorch reference of HMR + SMPL: images -> (posed vertices, camera).

The model as the configurations state it: ResNet-50 (He et al. 2015, the
torchvision v1.5 bottleneck with its stride on the 3x3 convolution) with
inference BatchNorm, global average pooling, and the iterative-error-feedback
regressor of HMR as SPIN publishes it (Kolotouros et al. 2019,
``models/hmr.py``: 2048 + 144 + 13 -> 1024 -> 1024, three iterations, a 6D
pose of 24 joints, 10 betas, 3 camera values).  One departure from SPIN,
as the system under test defines the model: a ReLU follows fc1 and fc2.
The 6D pose becomes rotation matrices by Gram-Schmidt on its two columns,
and SMPL (Loper et al. 2015) poses the body by linear blend skinning.

Everything is float32 with TF32 off, computed in blocks of frames.  It
reads only the weights, body and images the benchmark made; it imports
nothing of the program.

``operand`` rounds each operand of the layers the program computes in a
lower precision (the backbone's convolutions, fc1 and fc2): the identity
for the reference, :func:`fp8` for the control.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0      # largest finite float8_e4m3fn

Operand = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its absolute maximum maps to
    448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _f32(w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return w[name].float()


def batch_norm(w, name: str, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm: (x - mean) / sqrt(var + eps) * gamma + beta."""
    g = _f32(w, name + ".weight") / torch.sqrt(
        _f32(w, name + ".running_var") + BN_EPS)
    b = _f32(w, name + ".bias") - _f32(w, name + ".running_mean") * g
    return x * g[:, None, None] + b[:, None, None]


def conv(w, name: str, x: torch.Tensor, stride: int, padding: int,
         operand: Operand) -> torch.Tensor:
    return F.conv2d(operand(x), operand(_f32(w, name + ".weight")),
                    stride=stride, padding=padding)


def bottleneck(w, name: str, x: torch.Tensor, stride: int,
               operand: Operand) -> torch.Tensor:
    y = torch.relu(batch_norm(w, name + ".bn1",
                              conv(w, name + ".conv1", x, 1, 0, operand)))
    y = torch.relu(batch_norm(w, name + ".bn2",
                              conv(w, name + ".conv2", y, stride, 1, operand)))
    y = batch_norm(w, name + ".bn3",
                   conv(w, name + ".conv3", y, 1, 0, operand))
    if name + ".downsample.0.weight" in w:
        x = batch_norm(w, name + ".downsample.1",
                       conv(w, name + ".downsample.0", x, stride, 0, operand))
    return torch.relu(y + x)


def resnet50(w, images: torch.Tensor, stage_sizes,
             operand: Operand = exact) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, 2048) pooled features."""
    x = images.permute(0, 3, 1, 2).float()
    x = torch.relu(batch_norm(w, "bn1", conv(w, "conv1", x, 2, 3, operand)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            stride = 2 if (j == 0 and i > 0) else 1
            x = bottleneck(w, f"layer{i + 1}.{j}", x, stride, operand)
    return x.mean(dim=(2, 3))


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): the 6 numbers are the first two columns,
    read as (3, 2); Gram-Schmidt, the third column their cross product."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    b1 = F.normalize(m[..., 0], dim=-1)
    a2 = m[..., 1]
    b2 = F.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def ief(w, feats: torch.Tensor, mean_params: torch.Tensor, n_iter: int,
        operand: Operand = exact):
    """Pooled features -> (rotation matrices (B, 24, 3, 3), betas (B, 10),
    camera (B, 3))."""
    B = feats.shape[0]
    mean = mean_params.float()
    pose = mean[:144].expand(B, 144)
    shape = mean[144:154].expand(B, 10)
    cam = mean[154:157].expand(B, 3)

    def dense(name, v, op=exact):
        return F.linear(op(v), op(_f32(w, name + ".weight")),
                        _f32(w, name + ".bias"))

    for _ in range(n_iter):
        xc = torch.cat([feats, pose, shape, cam], dim=-1)
        h = torch.relu(dense("fc1", xc, operand))
        h = torch.relu(dense("fc2", h, operand))
        pose = pose + dense("decpose", h)
        shape = shape + dense("decshape", h)
        cam = cam + dense("deccam", h)
    rotmats = rot6d_to_rotmat(pose.reshape(B, 24, 6))
    return rotmats, shape, cam


def smpl_vertices(body: Dict[str, torch.Tensor], parents,
                  rotmats: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """SMPL's linear blend skinning: (B, J, 3, 3) rotations, (B, S) betas
    -> (B, V, 3) posed vertices."""
    B, J = rotmats.shape[:2]
    v_shaped = body["v_template"] + torch.einsum(
        "vcs,bs->bvc", body["shapedirs"], betas)
    joints = torch.einsum("jv,bvc->bjc", body["j_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", body["posedirs"],
                                      pose_feature)
    world_R, world_t = [rotmats[:, 0]], [joints[:, 0]]
    for i in range(1, J):
        p = parents[i]
        world_R.append(world_R[p] @ rotmats[:, i])
        world_t.append(world_t[p] + (world_R[p] @ (joints[:, i] - joints[:, p])
                                     [..., None])[..., 0])
    R = torch.stack(world_R, dim=1)                          # (B, J, 3, 3)
    t = torch.stack(world_t, dim=1) - (R @ joints[..., None])[..., 0]
    A = torch.cat([R, t[..., None]], dim=-1)                 # (B, J, 3, 4)
    T = torch.einsum("vj,bjrc->bvrc", body["weights"], A)    # (B, V, 3, 4)
    return (T[..., :3] @ v_posed[..., None])[..., 0] + T[..., 3]


@torch.no_grad()
def forward(weights: Dict[str, torch.Tensor], body: Dict[str, torch.Tensor],
            parents, mean_params: torch.Tensor, images: torch.Tensor,
            stage_sizes, n_iter: int, operand: Operand = exact,
            block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images (N, H, W, 3) -> (vertices (N, V, 3), camera (N, 3)), float32,
    ``block`` frames at a time."""
    verts, cams = [], []
    with no_tf32():
        for s in range(0, images.shape[0], block):
            feats = resnet50(weights, images[s:s + block], stage_sizes,
                             operand)
            rotmats, betas, cam = ief(weights, feats, mean_params, n_iter,
                                      operand)
            verts.append(smpl_vertices(body, parents, rotmats, betas))
            cams.append(cam)
    return torch.cat(verts), torch.cat(cams)
