"""HMR: ResNet-50 encoder + iterative-error-feedback SMPL regressor
(port of ``tpubody.models.hmr``).

Input (B, H, W, 3) NHWC normalised images -> rotation matrices (B, 24, 3,
3), shape (B, 10) and weak-perspective camera (B, 3).  As in the JAX
model, the backbone and ``fc1``/``fc2`` run in the compute dtype (bf16 on
the card; the NHWC input permuted to NCHW is already channels_last, and
the conv weights are kept channels_last), while ``decpose``/``decshape``/
``deccam`` and the IEF state stay fp32.  IEF is a static loop; dropout and
BatchNorm follow ``module.train()`` / ``eval()`` (eval at inference).

State-dict names follow the reference torch model (torchvision-style
``conv1``, ``layer{1..4}.{j}.conv{1..3}``, ``downsample.0/1``) under a
``backbone.`` prefix, the counterpart of the Flax ``backbone`` scope.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpubody_torch.core.rotations import rot6d_to_rotmat
from tpubody_torch.device import DeviceLike, resolve

NPOSE = 24 * 6  # 144: 24 joints x 6D rotation
STEMS = ("conv7", "s2d")
HEADS = ("fc1", "fc2", "decpose", "decshape", "deccam")


class HMROutput(NamedTuple):
    rotmats: torch.Tensor  # (B, 24, 3, 3)
    shape: torch.Tensor    # (B, 10)
    cam: torch.Tensor      # (B, 3) weak-perspective (s, tx, ty)
    pose6d: torch.Tensor   # (B, 144) raw 6D pose (pre-Gram-Schmidt)


def _bn(ch: int) -> nn.BatchNorm2d:
    # Flax momentum 0.9 on the running average == torch momentum 0.1.
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """ResNet-v1 bottleneck block (NCHW inside the backbone)."""

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides,
                               padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = _bn(features * 4)
        self.downsample = None
        if in_features != features * 4 or strides != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, features * 4, 1, stride=strides,
                          bias=False),
                _bn(features * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """ResNet-50 feature extractor: (B, H, W, 3) NHWC -> (B, 2048) pooled
    features, computed in the dtype of its weights.  ``stage_sizes`` lets
    tests build a shallow one.

    ``stem`` selects how the 7x7/stride-2 input convolution is computed:
    ``"conv7"`` (default) directly, ``"s2d"`` by space-to-depth: RGB is
    zero-padded to 4 channels, 2x2 pixel blocks fold into channels
    ((B, H/2, W/2, 16)), and an equivalent 4x4/stride-1 convolution gives
    the same outputs.  The parameter stays the canonical (64, 3, 7, 7)
    ``conv1.weight`` and is rearranged in ``forward``, so state dicts do
    not depend on the stem.  An odd height or width falls back to conv7."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stem: str = "conv7"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem={stem!r}: expected one of {STEMS}")
        self.stage_sizes = tuple(stage_sizes)
        self.stem_kind = stem
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_features = 64
        for i, (n_blocks, feats) in enumerate(
                zip(self.stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                strides = 2 if (j == 0 and i > 0) else 1
                blocks.append(Bottleneck(in_features, feats, strides))
                in_features = feats * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def _conv1_s2d(self, images: torch.Tensor) -> torch.Tensor:
        """Space-to-depth stem.  out[i, j] = sum_{u,v} x[2i+u-3, 2j+v-3]
        w[u, v]; with rows r = 2p + a (block p, parity a) and p = i - 2 + P
        for kernel tap P in [0, 4), u = 2P + a - 1: tap (P, a) = (0, 0)
        falls outside the 7x7 kernel and carries zero weight."""
        B, H, W, _ = images.shape
        OH, OW = H // 2, W // 2
        w = self.conv1.weight                            # (64, 3, 7, 7)
        # pad rows and columns in front to 8x8 and channels 3 -> 4, split
        # as (O, c, P, a, Q, b), reorder to (O, (a, b, c), P, Q)
        k8 = F.pad(w, (1, 0, 1, 0, 0, 1)).reshape(64, 4, 4, 2, 4, 2)
        k4 = k8.permute(0, 3, 5, 1, 2, 4).reshape(64, 16, 4, 4)
        xb = F.pad(images.to(w.dtype), (0, 1)).reshape(B, OH, 2, OW, 2, 4)
        y = xb.permute(0, 1, 3, 2, 4, 5).reshape(B, OH, OW, 16)
        y = F.pad(y.permute(0, 3, 1, 2), (2, 1, 2, 1))   # stays channels_last
        return F.conv2d(y, k4.contiguous(memory_format=torch.channels_last))

    def stem(self, images: torch.Tensor) -> torch.Tensor:
        """conv1 + bn1 + relu + maxpool: (B, H, W, 3) NHWC -> (B, 64, H/4,
        W/4), channels_last in memory."""
        if (self.stem_kind == "s2d" and images.shape[1] % 2 == 0
                and images.shape[2] % 2 == 0):
            x = self._conv1_s2d(images)
        else:
            # NHWC permuted to NCHW is channels_last in memory: no copy.
            x = self.conv1(images.permute(0, 3, 1, 2)
                           .to(self.conv1.weight.dtype))
        return self.maxpool(torch.relu(self.bn1(x)))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.stem(images)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return torch.mean(x, dim=(2, 3))   # global average pool


class HMR(nn.Module):
    """HMR regressor.  ``mean_params``: (144 + 10 + 3,) initial estimate."""

    def __init__(self, mean_params: np.ndarray, n_iter: int = 3,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 stem: str = "conv7"):
        super().__init__()
        self.n_iter = n_iter
        self.register_buffer(
            "mean_params", torch.as_tensor(np.asarray(mean_params, np.float32)),
            persistent=False)
        self.backbone = ResNet50(stage_sizes, stem)
        self.fc1 = nn.Linear(2048 + NPOSE + 13, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, NPOSE)
        self.decshape = nn.Linear(1024, 10)
        self.deccam = nn.Linear(1024, 3)
        self.drop = nn.Dropout(0.5)

    def forward(self, images: torch.Tensor) -> HMROutput:
        """images: (B, H, W, 3) NHWC, normalised."""
        return self.ief(self.backbone(images))

    def ief(self, xf: torch.Tensor) -> HMROutput:
        """The IEF head on pooled features (B, 2048)."""
        B = xf.shape[0]
        dt = self.fc1.weight.dtype
        xf = xf.to(dt)
        mean = self.mean_params
        pose = mean[:NPOSE].expand(B, NPOSE)
        shape = mean[NPOSE:NPOSE + 10].expand(B, 10)
        cam = mean[NPOSE + 10:NPOSE + 13].expand(B, 3)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pose.to(dt), shape.to(dt), cam.to(dt)], dim=-1)
            h = self.drop(torch.relu(self.fc1(xc)))
            h = self.drop(torch.relu(self.fc2(h)))
            h32 = h.float()
            pose = pose + self.decpose(h32)
            shape = shape + self.decshape(h32)
            cam = cam + self.deccam(h32)
        rotmats = rot6d_to_rotmat(pose.reshape(B, 24, 6)).reshape(B, 24, 3, 3)
        return HMROutput(rotmats=rotmats, shape=shape, cam=cam, pose6d=pose)


def default_mean_params(seed: int = 0) -> np.ndarray:
    """Deterministic stand-in for the reference's ``smpl_mean_params.npz``:
    identity 6D rotations, zero shape, unit-scale camera."""
    del seed
    ident6d = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24)
    shape = np.zeros(10, np.float32)
    cam = np.array([0.9, 0.0, 0.0], np.float32)
    return np.concatenate([ident6d, shape, cam])


def load_mean_params(path: str) -> np.ndarray:
    """Load the reference mean-params npz (keys pose (144,), shape (10,),
    cam (3,))."""
    z = np.load(path)
    return np.concatenate([
        np.asarray(z["pose"], np.float32).reshape(-1),
        np.asarray(z["shape"], np.float32).reshape(-1),
        np.asarray(z["cam"], np.float32).reshape(-1),
    ])


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded initialisation on the CPU generator, so a seed gives the
    same weights on every device: LeCun-normal convolutions and dense
    layers (the Flax default), identity BatchNorm, and the decoder heads
    xavier-uniform with gain 0.01 as in the reference HMR."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
        elif isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            if name in ("decpose", "decshape", "deccam"):
                bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen)
                                * 2 - 1) * bound)
            else:
                normal(m.weight, 1.0 / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def to_compute(model: HMR, dtype: torch.dtype,
               device: torch.device) -> HMR:
    """Move ``model`` to ``device`` with the backbone convolutions and
    fc1/fc2 in the compute ``dtype`` (conv weights channels_last); the
    BatchNorm parameters and statistics and the decoder heads stay fp32,
    as Flax keeps its parameters.  Eval mode."""
    model.to(device)
    for m in model.backbone.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype=dtype, memory_format=torch.channels_last)
    model.fc1.to(dtype)
    model.fc2.to(dtype)
    return model.eval()


def create_hmr(
    mean_params: Optional[np.ndarray] = None,
    n_iter: int = 3,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    stem: str = "conv7",
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    device: DeviceLike = "cuda",
) -> HMR:
    """Build an HMR module with seeded random weights, on ``device``, in
    eval mode.  ``stem``: "conv7" or "s2d" (see :class:`ResNet50`)."""
    dev = resolve(device)
    if mean_params is None:
        mean_params = default_mean_params()
    model = HMR(mean_params, n_iter=n_iter, stage_sizes=stage_sizes,
                stem=stem)
    init_weights(model, seed)
    return to_compute(model, dtype, dev)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def from_flax_variables(variables) -> Dict[str, torch.Tensor]:
    """A ``tpubody`` Flax variable tree ``{"params", "batch_stats"}`` (numpy
    leaves) -> this package's state_dict: HWIO kernels become OIHW, Dense
    ``(in, out)`` becomes ``(out, in)``, BatchNorm ``scale/bias/mean/var``
    become ``weight/bias/running_mean/running_var``.  Accepts the tree of
    an ``HMR`` or of a bare ``ResNet50``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst, kernel):
        sd[dst + ".weight"] = _as_tensor(kernel).permute(3, 2, 0, 1).contiguous()

    def bn(dst, p, s):
        sd[dst + ".weight"] = _as_tensor(p["scale"])
        sd[dst + ".bias"] = _as_tensor(p["bias"])
        sd[dst + ".running_mean"] = _as_tensor(s["mean"])
        sd[dst + ".running_var"] = _as_tensor(s["var"])
        sd[dst + ".num_batches_tracked"] = torch.tensor(0)

    def resnet(prefix, p, s):
        conv(prefix + "conv1", p["conv1"]["kernel"])
        bn(prefix + "bn1", p["bn1"], s["bn1"])
        for scope in sorted(k for k in p if k.startswith("layer")):
            stage, block = scope[len("layer"):].split("_")
            dst = f"{prefix}layer{stage}.{block}."
            bp, bs = p[scope], s[scope]
            for c in (1, 2, 3):
                conv(dst + f"conv{c}", bp[f"conv{c}"]["kernel"])
                bn(dst + f"bn{c}", bp[f"bn{c}"], bs[f"bn{c}"])
            if "downsample_conv" in bp:
                conv(dst + "downsample.0", bp["downsample_conv"]["kernel"])
                bn(dst + "downsample.1", bp["downsample_bn"],
                   bs["downsample_bn"])

    if "backbone" in params:
        resnet("backbone.", params["backbone"], stats["backbone"])
        for name in HEADS:
            sd[name + ".weight"] = _as_tensor(params[name]["kernel"]).t().contiguous()
            sd[name + ".bias"] = _as_tensor(params[name]["bias"])
    else:
        resnet("", params, stats)
    return sd


def load_reference_state_dict(model: HMR, state_dict) -> HMR:
    """Load a reference torch HMR checkpoint ``{name: array}``
    (torchvision-style names, heads at the top level) into ``model``: the
    counterpart of ``tpubody``'s ``convert_torch_state_dict``.  BatchNorm
    ``num_batches_tracked`` counters may be absent."""
    sd = {(k if k.split(".")[0] in HEADS else "backbone." + k):
          torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
          else v.detach().cpu() for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"checkpoint mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model
