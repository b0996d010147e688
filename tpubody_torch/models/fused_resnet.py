"""Fused residual stage for ResNet inference (port of
``tpubody.models.pallas_resnet``).

A chain of stride-1 bottlenecks with BatchNorm folded into the weights,
bf16 operands, f32 accumulation and bf16 roundings between the
convolutions, computed by the hand-written CUDA kernel
``csrc/fused_stage.cu``: one launch a bottleneck, ``h1`` and ``h2`` never
leaving shared memory.  As in ``tpubody``, the fused stage is an experiment
measured beside the library's convolutions (``tpubody_torch.bench
--fused-stage``); ``models/hmr.py`` does not route through it.

:func:`run_stage` keeps the JAX layout (NHWC in, NHWC out).  On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it takes
:func:`run_stage_reference`, the plain PyTorch version with the same
roundings.  The kernel needs no even ``C_mid`` (that rule came with the
TPU's packed rolls and is dropped): any widths run, because
:func:`fuse_stage` pads the *weights* with zeros to multiples of 16 once,
and the kernel masks the activations' ragged channels itself.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpubody_torch import native

BN_EPS = 1e-5      # the BatchNorm epsilon of models/hmr.py
MAX_SMEM = 232448  # bytes of shared memory a Hopper block can have
FIELDS = ("A1_0", "b1_0", "A2_0", "b2_0", "A3_0", "b3_0", "Ad", "bd",
          "A1_r", "b1_r", "A2_r", "b2_r", "A3_r", "b3_r")


def _round16(c: int) -> int:
    return (c + 15) // 16 * 16


def _pad(x: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out.contiguous()


def _pack_block(A1, b1, A2, b2, A3, b3, Ad, bd) -> Dict[str, object]:
    """One bottleneck's matrices in the kernel's layout: every channel
    count rounded up to a multiple of 16 with zeros, the 3x3 weights
    tap-major as (9, C_mid, C_mid)."""
    c_mid, c_in = A1.shape
    c_out = A3.shape[0]
    pm, pi, po = _round16(c_mid), _round16(c_in), _round16(c_out)
    w2 = A2.reshape(c_mid, 9, c_mid).permute(1, 0, 2)
    packed = {
        "c_in": c_in, "c_mid": c_mid, "c_out": c_out,
        "w1": _pad(A1, (pm, pi)), "b1": _pad(b1.reshape(-1), (pm,)),
        "w2": _pad(w2, (9, pm, pm)), "b2": _pad(b2.reshape(-1), (pm,)),
        "w3": _pad(A3, (po, pm)), "b3": _pad(b3.reshape(-1), (po,)),
        "wd": None, "bd": None,
    }
    if Ad is not None:
        packed["wd"] = _pad(Ad, (po, pi))
        packed["bd"] = _pad(bd.reshape(-1), (po,))
    return packed


@dataclasses.dataclass
class FusedStage:
    """BN-folded weights of one residual stage.

    The fields have ``tpubody``'s names, shapes and types: block 0 may
    change width (C_in -> C_out) through a downsample 1x1; blocks 1..n-1
    are uniform (C_out -> C_out).  A matrices are (out channels,
    contraction) bf16; biases are (C, 1) f32; where ``n_rest`` is 0 the
    ``*_r`` fields hold one zero block that nothing reads.  ``packed``
    holds the same weights per block in the CUDA kernel's layout (see
    :func:`_pack_block`), built once here.
    """

    A1_0: torch.Tensor            # (C_mid, C_in)
    b1_0: torch.Tensor
    A2_0: torch.Tensor            # (C_mid, 9 * C_mid), taps (dy, dx) row-major
    b2_0: torch.Tensor
    A3_0: torch.Tensor            # (C_out, C_mid)
    b3_0: torch.Tensor
    Ad: Optional[torch.Tensor]    # (C_out, C_in) or None (identity residual)
    bd: Optional[torch.Tensor]
    A1_r: torch.Tensor            # (max(n - 1, 1), C_mid, C_out)
    b1_r: torch.Tensor
    A2_r: torch.Tensor            # (max(n - 1, 1), C_mid, 9 * C_mid)
    b2_r: torch.Tensor
    A3_r: torch.Tensor            # (max(n - 1, 1), C_out, C_mid)
    b3_r: torch.Tensor
    n_rest: int = 0
    packed: List[Dict[str, object]] = dataclasses.field(
        default_factory=list, repr=False, compare=False)

    def __post_init__(self):
        if not self.packed:
            self.packed = [_pack_block(*blk) for blk in self.blocks()]

    def blocks(self):
        """Per bottleneck (A1, b1, A2, b2, A3, b3, Ad, bd) in the reference
        layout; Ad and bd are None for an identity residual."""
        out = [(self.A1_0, self.b1_0, self.A2_0, self.b2_0, self.A3_0,
                self.b3_0, self.Ad, self.bd)]
        for j in range(self.n_rest):
            out.append((self.A1_r[j], self.b1_r[j], self.A2_r[j],
                        self.b2_r[j], self.A3_r[j], self.b3_r[j], None, None))
        return out

    def as_reference_layout(self) -> Dict[str, Optional[torch.Tensor]]:
        """The fields under ``tpubody``'s names, in its shapes and types."""
        return {name: getattr(self, name) for name in FIELDS}

    @property
    def device(self) -> torch.device:
        return self.A1_0.device

    def to(self, device) -> "FusedStage":
        def move(x):
            return x.to(device) if isinstance(x, torch.Tensor) else x

        fields = {name: move(getattr(self, name)) for name in FIELDS}
        packed = [{k: move(v) for k, v in blk.items()} for blk in self.packed]
        return FusedStage(**fields, n_rest=self.n_rest, packed=packed)


def _fold_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """Fold inference BatchNorm into a convolution's weights and a
    per-channel bias, in float64: y = g * (conv(x) - m) + b with
    g = scale / sqrt(var + eps).  -> (OIHW weights, bias), numpy float64."""
    def f64(t):
        return t.detach().cpu().to(torch.float32).numpy().astype(np.float64)

    g = f64(bn.weight) / np.sqrt(f64(bn.running_var) + BN_EPS)
    kf = f64(conv.weight) * g[:, None, None, None]
    bf = f64(bn.bias) - f64(bn.running_mean) * g
    return kf, bf


def _block_mats(block) -> Dict[str, np.ndarray]:
    """One Bottleneck -> float64 matrices.  Tap order in A2's columns is
    (dy, dx) row-major, then the input channel."""
    if block.conv2.stride != (1, 1):
        raise ValueError("only stride-1 bottlenecks can be fused")
    k1, b1 = _fold_bn(block.conv1, block.bn1)
    k2, b2 = _fold_bn(block.conv2, block.bn2)
    k3, b3 = _fold_bn(block.conv3, block.bn3)
    c_mid = k1.shape[0]
    out = dict(A1=k1[:, :, 0, 0], b1=b1,
               A2=np.transpose(k2, (0, 2, 3, 1)).reshape(c_mid, 9 * c_mid),
               b2=b2, A3=k3[:, :, 0, 0], b3=b3)
    if block.downsample is not None:
        kd, bd = _fold_bn(block.downsample[0], block.downsample[1])
        out["Ad"] = kd[:, :, 0, 0]
        out["bd"] = bd
    return out


def _bf16(x: np.ndarray) -> torch.Tensor:
    # float64 -> float32 -> bf16, each to nearest even: the route of
    # tpubody's jnp.asarray(float64 array, bfloat16).
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16)


def _bias(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(x, np.float32).reshape(-1, 1))


def fuse_stage(stage: Union[nn.Sequential, Sequence[nn.Module]],
               blocks: Sequence[int]) -> FusedStage:
    """Build a FusedStage (on the CPU; move it with ``.to``) from the
    ``Bottleneck`` modules ``stage[j] for j in blocks`` of
    ``tpubody_torch.models.hmr``: e.g. ``fuse_stage(model.backbone.layer1,
    [0, 1, 2])``.  The blocks must be contiguous and stride-1; block
    ``blocks[0]`` may carry the downsample, later ones must not."""
    mats = [_block_mats(stage[j]) for j in blocks]
    first, rest = mats[0], mats[1:]
    if any("Ad" in m for m in rest):
        raise ValueError("only the first fused block may downsample")
    c_mid, c_out = first["A1"].shape[0], first["A3"].shape[0]
    rest_shapes = {"A1": (c_mid, c_out), "A2": (c_mid, 9 * c_mid),
                   "A3": (c_out, c_mid), "b1": (c_mid, 1), "b2": (c_mid, 1),
                   "b3": (c_out, 1)}

    def stack(key):
        if not rest:
            # one zero block keeps the shapes; n_rest = 0 means it is unread
            return torch.zeros((1,) + rest_shapes[key],
                               dtype=torch.bfloat16 if key[0] == "A"
                               else torch.float32)
        cast = _bf16 if key[0] == "A" else _bias
        return torch.stack([cast(m[key]) for m in rest])

    return FusedStage(
        A1_0=_bf16(first["A1"]), b1_0=_bias(first["b1"]),
        A2_0=_bf16(first["A2"]), b2_0=_bias(first["b2"]),
        A3_0=_bf16(first["A3"]), b3_0=_bias(first["b3"]),
        Ad=_bf16(first["Ad"]) if "Ad" in first else None,
        bd=_bias(first["bd"]) if "bd" in first else None,
        A1_r=stack("A1"), b1_r=stack("b1"), A2_r=stack("A2"),
        b2_r=stack("b2"), A3_r=stack("A3"), b3_r=stack("b3"),
        n_rest=len(rest))


def fused_stage_from_numpy(arrays: Dict[str, Optional[np.ndarray]],
                           n_rest: int) -> FusedStage:
    """The fields of a ``tpubody`` FusedStage as numpy arrays -> the port's.
    A matrices are bf16 bit patterns (uint16) or float32 holding bf16
    values; biases float32.  ``Ad``/``bd`` may be None or absent."""
    def tensor(name):
        a = arrays.get(name)
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        if name[0] == "A":
            if a.dtype == np.uint16:
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.astype(np.float32))

    fields = {name: tensor(name) for name in FIELDS}
    missing = [n for n in FIELDS if fields[n] is None and n not in ("Ad", "bd")]
    if missing:
        raise KeyError(f"missing fields {missing}")
    return FusedStage(**fields, n_rest=int(n_rest))


def _check_input(x_nhwc: torch.Tensor, stage: FusedStage):
    if x_nhwc.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C_in), got {tuple(x_nhwc.shape)}")
    c_in = stage.A1_0.shape[1]
    if x_nhwc.shape[-1] != c_in:
        raise ValueError(f"x has {x_nhwc.shape[-1]} channels, the stage "
                         f"takes {c_in}")
    if stage.Ad is None and stage.A3_0.shape[0] != c_in:
        raise ValueError("an identity residual needs C_in == C_out")
    if stage.device != x_nhwc.device:
        raise ValueError(f"x is on {x_nhwc.device}, the stage on "
                         f"{stage.device}")


def run_stage_reference(x_nhwc: torch.Tensor,
                        stage: FusedStage) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with its roundings:
    operands in bf16, products summed in f32 (float32 convolutions of
    bf16 values; they do not depend on the TF32 switches' rounding of the
    operands, since a bf16 value is a TF32 value), bias and relu in f32,
    ``h1``, ``h2`` and every block's ``y`` rounded to bf16; the residual of
    a widening block stays f32 until the add.
    (B, H, W, C_in) -> (B, H, W, C_out) bf16."""
    _check_input(x_nhwc, stage)

    def conv(h, A, b, taps=1):
        w = A.float()
        if taps == 1:
            w = w[:, :, None, None]
        else:
            c_mid = A.shape[0]
            w = w.reshape(c_mid, 3, 3, c_mid).permute(0, 3, 1, 2)
        return F.conv2d(h, w, padding=taps // 2) + b.reshape(1, -1, 1, 1)

    def rounded(v):
        return v.to(torch.bfloat16).float()

    y = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2).float()
    for A1, b1, A2, b2, A3, b3, Ad, bd in stage.blocks():
        res = y if Ad is None else conv(y, Ad, bd)
        h1 = rounded(torch.relu(conv(y, A1, b1)))
        h2 = rounded(torch.relu(conv(h1, A2, b2, taps=3)))
        y = rounded(torch.relu(conv(h2, A3, b3) + res))
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def run_stage(x_nhwc: torch.Tensor, stage: FusedStage) -> torch.Tensor:
    """Apply a fused residual stage: (B, H, W, C_in) -> (B, H, W, C_out)
    bf16.  Stride-1 blocks only.  A CUDA tensor goes through the kernel,
    one launch a bottleneck (``native.LAUNCHES["fused_stage"]`` counts
    them), or this raises; a CPU tensor through
    :func:`run_stage_reference`."""
    _check_input(x_nhwc, stage)
    device = x_nhwc.device
    if device.type == "cpu":
        return run_stage_reference(x_nhwc, stage)
    if device.type != "cuda":
        raise ValueError(f"run_stage runs on CUDA or CPU tensors, got {device}")
    B, H, W, _ = x_nhwc.shape
    if B > 65535:
        raise ValueError("at most 65,535 images a call")
    lib = native.library()
    for blk in stage.packed:
        need = lib.tpubody_fused_stage_smem_bytes(blk["c_mid"],
                                                  int(blk["wd"] is not None))
        if need > MAX_SMEM:
            raise ValueError(
                f"C_mid = {blk['c_mid']} needs {need} bytes of shared memory "
                f"a block; the card has {MAX_SMEM}")
    y = x_nhwc.to(torch.bfloat16).contiguous()

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        for blk in stage.packed:
            x = y
            if x.data_ptr() % 16:
                raise ValueError("x is not 16-byte aligned")
            y = torch.empty((B, H, W, blk["c_out"]), dtype=torch.bfloat16,
                            device=device)
            err = lib.tpubody_fused_stage_block(
                ptr(x), ptr(y), ptr(blk["w1"]), ptr(blk["b1"]),
                ptr(blk["w2"]), ptr(blk["b2"]), ptr(blk["w3"]),
                ptr(blk["b3"]), ptr(blk["wd"]), ptr(blk["bd"]), B, H, W,
                blk["c_in"], blk["c_mid"], blk["c_out"], stream)
            native.check(err, "fused_stage launch")
            native.LAUNCHES["fused_stage"] += 1
    return y
