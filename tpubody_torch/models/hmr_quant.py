"""Post-training int8 quantization (PTQ) for HMR inference (port of
``tpubody.models.hmr_quant``).

Fold inference BatchNorm into each convolution, quantize weights per
output channel and activations per tensor (symmetric, scale-only), and run
the backbone's convolutions as int8 products with int32 sums:

  * :func:`fold_batchnorm` — the fold of the inference BatchNorm affine
    into each conv's weights and a new bias, in float32 as ``tpubody``
    does it (``g = scale / sqrt(var + eps)``, ``w * g``, ``beta - mean *
    g``), read from the port's :class:`~tpubody_torch.models.hmr.HMR`;
  * :func:`calibrate` — the folded float32 network on representative
    images, recording each conv input's absolute maximum -> activation
    scales;
  * :func:`quantize` / :func:`forward` — int8 weights and scales; at run
    time each conv quantizes its input, multiplies int8 by int8 into
    int32 sums, and dequantizes into a float32 epilogue (bias, relu and
    residual adds stay float32).

The IEF head stays float32.  ``tpubody`` computes the int8 convolution in
XLA (``conv_general_dilated`` with int32 sums), not in Pallas, so here it
is an im2col of the int8 input and one library product, ``torch._int_mm``,
on the card.  The epilogue and the next convolution's quantize are one
step, :func:`requantize`: on the card one launch of the requantizing
epilogue kernel (``csrc/int8_requant.cu``) from the int32 sums to the
codes of every convolution that reads the output, bit-equal to the eager
chain (:func:`requantize_reference`, which the CPU runs).

``torch._int_mm`` on CUDA (torch 2.11, cuBLASLt; checked on an H100): the
first operand (M, K) needs M > 16, K and N multiples of 8, and at M = 17
only a row-major first operand with a column-major second one is taken
(CUBLAS_STATUS_NOT_SUPPORTED otherwise); that pairing is also the fast one
(``chip_smoke.py`` phase 24 checks these rules and times both layouts).  So a :class:`QConv` keeps its weights as (O, K)
row-major, whose transpose is that column-major (K, O) operand; K runs
over (kh, kw, c) as the im2col lays out its columns and is padded with
zero rows to a multiple of 8 (the stem: 7 * 7 * 3 = 147 -> 152); batches
of M <= 16 rows get zero rows.  On the CPU the products are taken in
float64 and cast to int32: exact, since |sum| <= 4608 * 127^2 < 2^53.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from tpubody_torch import native
from tpubody_torch.core.rotations import rot6d_to_rotmat
from tpubody_torch.device import DeviceLike, resolve
from tpubody_torch.dist import mesh as mesh_lib
from tpubody_torch.models import hmr as hmr_lib
from tpubody_torch.utils.profiling import span

HEADS = hmr_lib.HEADS
STAGE_SIZES = hmr_lib.STAGE_SIZES
BN_EPS = 1e-5

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class FoldedConv:
    w: torch.Tensor             # (KH, KW, I, O) f32, BN-folded (HWIO)
    b: torch.Tensor             # (O,) f32
    strides: Tuple[int, int]
    padding: Padding

    def to(self, device: DeviceLike) -> "FoldedConv":
        return dataclasses.replace(self, w=self.w.to(device),
                                   b=self.b.to(device))


@dataclasses.dataclass(frozen=True)
class QConv:
    w: torch.Tensor             # (O, K) int8; K = KH*KW*I over (kh, kw, c),
                                # zero-padded to a multiple of 8
    w_scale: torch.Tensor       # (O,) f32 per output channel
    b: torch.Tensor             # (O,) f32
    x_scale: torch.Tensor       # () f32 per-tensor input scale
    kernel: Tuple[int, int, int]   # (KH, KW, I)
    strides: Tuple[int, int]
    padding: Padding

    def hwio(self) -> torch.Tensor:
        """The int8 weights as ``tpubody`` holds them, (KH, KW, I, O)."""
        kh, kw, ci = self.kernel
        return self.w[:, :kh * kw * ci].t().reshape(kh, kw, ci, -1)

    def to(self, device: DeviceLike) -> "QConv":
        return dataclasses.replace(
            self, w=self.w.to(device), w_scale=self.w_scale.to(device),
            b=self.b.to(device), x_scale=self.x_scale.to(device))


def _fold(kernel: torch.Tensor, scale, bias, mean, var,
          eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm (scale, bias, mean, var) into an HWIO
    kernel and a bias, in float32.  The square root is the correctly
    rounded float32 one (taken in float64 and rounded once, which is
    exact for a square root): torch's vectorised CPU kernel misses it by
    an ulp on some inputs, where XLA, numpy and the card's ``sqrtf`` do
    not."""
    g = scale / torch.sqrt((var + eps).double()).float()
    return kernel * g, bias - mean * g


def _conv_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    k = conv.weight.detach().float().permute(2, 3, 1, 0).contiguous()
    return _fold(k, bn.weight.detach().float(), bn.bias.detach().float(),
                 bn.running_mean.float(), bn.running_var.float())


def fold_batchnorm(model: hmr_lib.HMR) -> dict:
    """The port's HMR (eval statistics) -> folded-conv tree mirroring the
    backbone: {"stem": FoldedConv, "blocks": [[{conv1, conv2, conv3
    [, down]}]], "head": {fc1, fc2, decpose, decshape, deccam: {"weight"
    (out, in), "bias"}}} (head parameters unchanged, float32).  The stem
    is the 7x7 ``conv1`` whichever stem the model computes it with."""
    bb = model.backbone
    stem = FoldedConv(*_conv_bn(bb.conv1, bb.bn1), (2, 2), ((3, 3), (3, 3)))
    blocks: List[List[Dict[str, FoldedConv]]] = []
    for i, n_blocks in enumerate(bb.stage_sizes):
        stage = []
        for j, blk in enumerate(getattr(bb, f"layer{i + 1}")):
            strides = (2, 2) if (j == 0 and i > 0) else (1, 1)
            folded = {
                "conv1": FoldedConv(*_conv_bn(blk.conv1, blk.bn1), (1, 1),
                                    ((0, 0), (0, 0))),
                "conv2": FoldedConv(*_conv_bn(blk.conv2, blk.bn2), strides,
                                    ((1, 1), (1, 1))),
                "conv3": FoldedConv(*_conv_bn(blk.conv3, blk.bn3), (1, 1),
                                    ((0, 0), (0, 0)))}
            if blk.downsample is not None:
                folded["down"] = FoldedConv(
                    *_conv_bn(blk.downsample[0], blk.downsample[1]), strides,
                    ((0, 0), (0, 0)))
            stage.append(folded)
        blocks.append(stage)
    head = {k: {"weight": getattr(model, k).weight.detach().float(),
                "bias": getattr(model, k).bias.detach().float()}
            for k in HEADS}
    return {"stem": stem, "blocks": blocks, "head": head}


@contextlib.contextmanager
def _exact_f32() -> Iterator[None]:
    """float32 convolutions and products without TF32 inside the block
    (cuDNN allows TF32 by default; it would move the calibration maxima
    by about 1e-3)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _symmetric(padding: Padding) -> Tuple[int, int]:
    (top, bottom), (left, right) = padding
    if top != bottom or left != right:
        raise ValueError(f"asymmetric padding {padding}")
    return top, left


def _conv_f32(fc: FoldedConv, x: torch.Tensor) -> torch.Tensor:
    """NHWC float32 convolution (cuDNN / the CPU's) + bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), fc.w.permute(3, 2, 0, 1),
                 stride=fc.strides, padding=_symmetric(fc.padding))
    return y.permute(0, 2, 3, 1) + fc.b


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 2, padding 1 (with -inf) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _backbone_f32(folded: dict, x: torch.Tensor,
                  observe: Optional[Callable] = None) -> torch.Tensor:
    """Folded float32 backbone; ``observe(name, x)`` sees each conv input
    (calibration).  Returns (B, 2048) pooled features."""
    def conv(fc, x, name):
        if observe is not None:
            observe(name, x)
        return _conv_f32(fc, x)

    x = _max_pool(torch.relu(conv(folded["stem"], x, "stem")))
    for i, stage in enumerate(folded["blocks"]):
        for j, blk in enumerate(stage):
            name = f"l{i}_{j}"
            y = torch.relu(conv(blk["conv1"], x, name + ".c1"))
            y = torch.relu(conv(blk["conv2"], y, name + ".c2"))
            y = conv(blk["conv3"], y, name + ".c3")
            res = conv(blk["down"], x, name + ".dn") if "down" in blk else x
            x = torch.relu(y + res)
    return torch.mean(x, dim=(1, 2))


def _ief_head(head: dict, xf: torch.Tensor, mean_params: np.ndarray,
              n_iter: int = 3) -> hmr_lib.HMROutput:
    """float32 IEF loop on pooled features (``HMR.ief`` in eval mode)."""
    with span("hmr.ief"):
        B = xf.shape[0]
        mean = torch.as_tensor(np.asarray(mean_params, np.float32),
                               device=xf.device)
        npose = hmr_lib.NPOSE
        pose = mean[:npose].expand(B, npose)
        shape = mean[npose:npose + 10].expand(B, 10)
        cam = mean[npose + 10:].expand(B, 3)

        def dense(name, v):
            return F.linear(v, head[name]["weight"], head[name]["bias"])

        for _ in range(n_iter):
            xc = torch.cat([xf, pose, shape, cam], dim=-1)
            h = torch.relu(dense("fc1", xc))
            h = torch.relu(dense("fc2", h))
            pose = pose + dense("decpose", h)
            shape = shape + dense("decshape", h)
            cam = cam + dense("deccam", h)
        rotmats = rot6d_to_rotmat(pose.reshape(B, 24, 6)).reshape(
            B, 24, 3, 3)
        return hmr_lib.HMROutput(rotmats=rotmats, shape=shape, cam=cam,
                                 pose6d=pose)


def _device_of(params: dict) -> torch.device:
    return params["stem"].b.device


def _images(images, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(images, dtype=torch.float32, device=device)


@torch.no_grad()
def forward_folded(folded: dict, images,
                   mean_params: Optional[np.ndarray] = None,
                   n_iter: int = 3) -> hmr_lib.HMROutput:
    """The float32 reference path on folded parameters (equal to the HMR
    in eval mode up to the fold's rounding), TF32 off."""
    if mean_params is None:
        mean_params = hmr_lib.default_mean_params()
    with _exact_f32():
        xf = _backbone_f32(folded, _images(images, _device_of(folded)))
        return _ief_head(folded["head"], xf, mean_params, n_iter)


@torch.no_grad()
def calibrate(folded: dict, images) -> Dict[str, float]:
    """Per-conv-input absolute maxima over a calibration batch -> scales
    (``max(m, 1e-8) / 127``), TF32 off; the maxima are read back once."""
    maxima: Dict[str, torch.Tensor] = {}

    def observe(name, x):
        maxima[name] = x.abs().amax()

    with _exact_f32():
        _backbone_f32(folded, _images(images, _device_of(folded)), observe)
    values = torch.stack(list(maxima.values())).cpu().tolist()
    return {k: max(v, 1e-8) / 127.0 for k, v in zip(maxima, values)}


def _pack(wq: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """int8 HWIO weights -> ((O, K) row-major, K padded to a multiple of
    8 with zeros; (KH, KW, I))."""
    kh, kw, ci, co = wq.shape
    k = kh * kw * ci
    return _pad_k(wq.reshape(k, co).t()).contiguous(), (kh, kw, ci)


def quantize(folded: dict, scales: Dict[str, float]) -> dict:
    """Folded float32 parameters + activation scales -> the int8
    :class:`QConv` tree (per-output-channel weight scales
    ``max(max|w|, 1e-12) / 127``, codes ``clip(round(w / s), -127, 127)``)."""
    def q(fc: FoldedConv, name: str) -> QConv:
        s_w = torch.clamp(fc.w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        wq = torch.clamp(torch.round(fc.w / s_w), -127, 127).to(torch.int8)
        w, kernel = _pack(wq)
        return QConv(w=w, w_scale=s_w.float(), b=fc.b.float(),
                     x_scale=torch.tensor(scales[name], dtype=torch.float32,
                                          device=fc.b.device),
                     kernel=kernel, strides=fc.strides, padding=fc.padding)

    blocks = []
    for i, stage in enumerate(folded["blocks"]):
        qstage = []
        for j, blk in enumerate(stage):
            name = f"l{i}_{j}"
            qblk = {k: q(blk[k], f"{name}.c{k[-1]}") for k in
                    ("conv1", "conv2", "conv3")}
            if "down" in blk:
                qblk["down"] = q(blk["down"], name + ".dn")
            qstage.append(qblk)
        blocks.append(qstage)
    return {"stem": q(folded["stem"], "stem"), "blocks": blocks,
            "head": folded["head"]}


def _quantize_input(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8: ``clip(round(x / s), -127, 127)`` (by
    division, as ``tpubody``; round half to even)."""
    return (x / x_scale).round_().clamp_(-127, 127).to(torch.int8)


def _pad_k(cols: torch.Tensor) -> torch.Tensor:
    k = cols.shape[1]
    return F.pad(cols, (0, (-k) % 8)) if k % 8 else cols


def _im2col(xq: torch.Tensor, kernel: Tuple[int, int, int],
            strides: Tuple[int, int], padding: Padding):
    """int8 NHWC -> ((M, K padded to 8) columns over (kh, kw, c), (B, OH,
    OW)).  A 1x1 convolution is a reshape (after a strided slice)."""
    B, H, W, C = xq.shape
    kh, kw, _ = kernel
    sh, sw = strides
    ph, pw = _symmetric(padding)
    if kh == kw == 1 and ph == pw == 0:
        if (sh, sw) != (1, 1):
            xq = xq[:, ::sh, ::sw]
        OH, OW = xq.shape[1:3]
        return _pad_k(xq.reshape(B * OH * OW, C)), (B, OH, OW)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    patches = xp.unfold(1, kh, sh).unfold(2, kw, sw)   # (B, OH, OW, C, kh, kw)
    OH, OW = patches.shape[1:3]
    k = kh * kw * C
    cols = xq.new_empty((B, OH, OW, k + (-k) % 8))
    cols[..., k:] = 0
    cols[..., :k].view(B, OH, OW, kh, kw, C).copy_(
        patches.permute(0, 1, 2, 4, 5, 3))
    return cols.view(B * OH * OW, -1), (B, OH, OW)


def _mm_int8(cols: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (O, K)ᵀ int8 -> (M, O) int32 sums (module docstring:
    cuBLASLt's rules on the card, float64 on the CPU)."""
    if cols.is_cuda:
        m = cols.shape[0]
        if m <= 16:
            cols = F.pad(cols, (0, 0, 0, 17 - m))
        return torch._int_mm(cols, w.t())[:m]
    return torch.mm(cols.double(), w.t().double()).to(torch.int32)


def _qconv(qc: QConv, x: torch.Tensor, relu: bool, name: str,
           observe: Optional[Callable]) -> torch.Tensor:
    """One convolution in eager torch ops, float32 in and out: quantize
    the input per tensor, int8 products with int32 sums, dequantize into
    the float32 epilogue (``acc * (x_scale * w_scale) + b``, then relu):
    the spans "hmr_quant.quantize" (with the im2col), "hmr_quant.products"
    and "hmr_quant.epilogue".  :func:`_backbone_int8` takes the same steps
    with :func:`requantize` between convolutions; the tests compose the
    eager chain from this."""
    with span("hmr_quant.quantize"):
        xq = _quantize_input(x, qc.x_scale)
        if observe is not None:
            observe(name, xq)
        cols, (B, OH, OW) = _im2col(xq, qc.kernel, qc.strides, qc.padding)
    with span("hmr_quant.products"):
        acc = _mm_int8(cols, qc.w)
    with span("hmr_quant.epilogue"):
        y = acc.float().mul_(qc.x_scale * qc.w_scale).add_(qc.b)
        if relu:
            y.relu_()
        return y.view(B, OH, OW, -1)


def requantize_reference(acc: torch.Tensor, qc: QConv, relu: bool,
                         res: Optional[torch.Tensor] = None,
                         scales: Sequence[torch.Tensor] = (),
                         keep: bool = False
                         ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The plain version of :func:`requantize`: the eager chain of
    :func:`_qconv`'s epilogue, the residual add with its relu, and one
    :func:`_quantize_input` a consumer scale."""
    y = acc.float().mul_(qc.x_scale * qc.w_scale).add_(qc.b)
    if relu:
        y.relu_()
    if res is not None:
        y.add_(res).relu_()
    return [_quantize_input(y, s) for s in scales], (y if keep else None)


def requantize(acc: torch.Tensor, qc: QConv, relu: bool,
               res: Optional[torch.Tensor] = None,
               scales: Sequence[torch.Tensor] = (), keep: bool = False
               ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """One convolution's int32 sums (M, O) -> (the int8 codes (M, O) for
    each consumer scale in ``scales``, the float32 output (M, O) if
    ``keep`` else None).  The output is ``acc * (x_scale * w_scale) + b``,
    relu'd if ``relu``; with ``res`` (M, O) float32 then ``relu(y +
    res)``; the codes are ``clip(round(y / s), -127, 127)``.

    On CUDA one launch of ``csrc/int8_requant.cu`` (at most two scales,
    O a multiple of 4), which writes only these outputs and gives the
    bits of :func:`requantize_reference`; anything else it does not take
    raises RuntimeError.  The CPU runs :func:`requantize_reference`."""
    if acc.device.type == "cpu":
        return requantize_reference(acc, qc, relu, res, scales, keep)
    if acc.device.type != "cuda" or acc.dim() != 2:
        raise RuntimeError(f"requantize takes (M, O) sums on CUDA or the "
                           f"CPU, got {tuple(acc.shape)} on {acc.device}")
    (M, O), dev = acc.shape, acc.device
    if O % 4 or len(scales) > 2:
        raise RuntimeError(f"requantize: O = {O} is not a multiple of 4 or "
                           f"{len(scales)} consumers are more than 2")
    f32 = torch.float32
    native.expect("acc", acc, (M, O), torch.int32, dev, aligned=True)
    native.expect("w_scale", qc.w_scale, (O,), f32, dev, aligned=True)
    native.expect("b", qc.b, (O,), f32, dev, aligned=True)
    native.expect("x_scale", qc.x_scale, (), f32, dev)
    if res is not None:
        native.expect("res", res, (M, O), f32, dev, aligned=True)
    for s in scales:
        native.expect("scale", s, (), f32, dev)
    codes = [torch.empty((M, O), dtype=torch.int8, device=dev)
             for _ in scales]
    out = (torch.empty((M, O), dtype=torch.float32, device=dev) if keep
           else None)

    def ptr(ts, i):
        return ts[i].data_ptr() if i < len(ts) else None

    native.launch("int8_requant", "tpubody_int8_requant", dev,
                  acc.data_ptr(), qc.w_scale.data_ptr(), qc.x_scale.data_ptr(),
                  qc.b.data_ptr(), None if res is None else res.data_ptr(),
                  ptr(scales, 0), ptr(scales, 1), ptr(codes, 0),
                  ptr(codes, 1), None if out is None else out.data_ptr(), M,
                  O, int(relu))
    return codes, out


def _sums(qc: QConv, x: torch.Tensor, name: str,
          observe: Optional[Callable]):
    """A convolution's input, int8 codes or float32 (quantized here: the
    images, the pooled stem output) -> its int32 sums (M, O) and (B, OH,
    OW): the spans "hmr_quant.quantize" (with the im2col) and
    "hmr_quant.products"."""
    with span("hmr_quant.quantize"):
        if x.dtype != torch.int8:
            x = _quantize_input(x, qc.x_scale)
        if observe is not None:
            observe(name, x)
        cols, shape = _im2col(x, qc.kernel, qc.strides, qc.padding)
    with span("hmr_quant.products"):
        return _mm_int8(cols, qc.w), shape


def _requant(acc: torch.Tensor, shape: Tuple[int, int, int], qc: QConv,
             relu: bool, res: Optional[torch.Tensor] = None,
             scales: Sequence[torch.Tensor] = (), keep: bool = False):
    """:func:`requantize` in the span "hmr_quant.epilogue", its outputs
    as NHWC (B, OH, OW, O)."""
    with span("hmr_quant.epilogue"):
        codes, y = requantize(acc, qc, relu,
                              None if res is None else res.view(acc.shape),
                              scales, keep)
    return ([c.view(*shape, -1) for c in codes],
            None if y is None else y.view(*shape, -1))


def _backbone_int8(qparams: dict, x: torch.Tensor,
                   observe: Optional[Callable] = None) -> torch.Tensor:
    """The int8 backbone on NHWC float32 images -> (B, 2048) pooled
    features.  ``observe(name, codes)`` sees each conv's int8 input, c1,
    c2, c3 then dn a block.  Each convolution's sums go through one
    :func:`requantize`, which writes the codes of every convolution that
    reads its output, one tensor a consumer's scale (a stage's first block
    has two, c1 and dn), and the float32 output only where a later step
    reads it as float: the stem's for the max-pool, a ``down`` branch, the
    residual of a block without one, the last block's for the mean.  The
    first block quantizes the pooled stem output itself.  The max-pool and
    the mean are spans "hmr_quant.epilogue" too."""
    blocks = [(f"l{i}_{j}", blk) for i, stage in enumerate(qparams["blocks"])
              for j, blk in enumerate(stage)]

    def readers(k: int):
        """Block k's input: its consumers' scales, and whether it is read
        as float (the residual, or the mean after the last block)."""
        if k == len(blocks):
            return [], True
        blk = blocks[k][1]
        convs = [blk["conv1"]] + ([blk["down"]] if "down" in blk else [])
        return [qc.x_scale for qc in convs], "down" not in blk

    stem = qparams["stem"]
    acc, shape = _sums(stem, x, "stem", observe)
    _, y = _requant(acc, shape, stem, True, keep=True)
    with span("hmr_quant.epilogue"):
        x = _max_pool(y)
    inputs = [x, x]       # block input as c1 and dn read it: here float32
    for k, (name, blk) in enumerate(blocks):
        acc, shape = _sums(blk["conv1"], inputs[0], name + ".c1", observe)
        (h,), _ = _requant(acc, shape, blk["conv1"], True,
                           scales=[blk["conv2"].x_scale])
        acc, shape = _sums(blk["conv2"], h, name + ".c2", observe)
        (h,), _ = _requant(acc, shape, blk["conv2"], True,
                           scales=[blk["conv3"].x_scale])
        acc, shape = _sums(blk["conv3"], h, name + ".c3", observe)
        if "down" in blk:
            dn, dn_shape = _sums(blk["down"], inputs[1], name + ".dn",
                                 observe)
            _, x = _requant(dn, dn_shape, blk["down"], False, keep=True)
        scales, keep = readers(k + 1)
        inputs, x = _requant(acc, shape, blk["conv3"], False, res=x,
                             scales=scales, keep=keep)
    with span("hmr_quant.epilogue"):
        return torch.mean(x, dim=(1, 2))


def forward(qparams: dict, images,
            mean_params: Optional[np.ndarray] = None,
            n_iter: int = 3) -> hmr_lib.HMROutput:
    """int8 inference: images (B, H, W, 3) -> HMROutput."""
    return QuantizedHMR(qparams, mean_params, n_iter)(images)


def quantize_hmr(model: hmr_lib.HMR, calib_images) -> dict:
    """One-call PTQ: the port's HMR + calibration images -> int8 parameters
    for :func:`forward`."""
    folded = fold_batchnorm(model)
    return quantize(folded, calibrate(folded, calib_images))


class QuantizedHMR:
    """The int8 model of the serving step: images -> HMROutput, as
    ``head(backbone(images))``, HMR's two parts.  ``mean_params`` defaults
    to ``hmr.default_mean_params()``."""

    def __init__(self, qparams: dict,
                 mean_params: Optional[np.ndarray] = None, n_iter: int = 3):
        self.qparams = qparams
        self.mean_params = mean_params
        self.n_iter = n_iter

    @torch.no_grad()
    def backbone(self, images) -> torch.Tensor:
        """The int8 backbone: images (B, H, W, 3) -> (B, 2048) features."""
        x = _images(images, _device_of(self.qparams))
        with span("hmr_quant.backbone"):
            return _backbone_int8(self.qparams, x)

    @torch.no_grad()
    def head(self, features: torch.Tensor) -> hmr_lib.HMROutput:
        """The float32 IEF head on the pooled features."""
        mean = (hmr_lib.default_mean_params() if self.mean_params is None
                else self.mean_params)
        return _ief_head(self.qparams["head"], features, mean, self.n_iter)

    def __call__(self, images) -> hmr_lib.HMROutput:
        return self.head(self.backbone(images))

    def to(self, device: DeviceLike) -> "QuantizedHMR":
        return QuantizedHMR(mesh_lib.copy_to(self.qparams, resolve(device)),
                            self.mean_params, self.n_iter)


def from_tpubody(tree: dict, device: DeviceLike = "cpu") -> dict:
    """``tpubody``'s folded (``fold_batchnorm``) or quantized (``quantize``,
    ``quantize_hmr``) tree with numpy leaves (HWIO weights; records as
    dataclasses or dicts) -> the port's tree on ``device``."""
    dev = resolve(device)

    def field(node, key):
        return node[key] if isinstance(node, dict) else getattr(node, key)

    def has(node, key):
        return key in node if isinstance(node, dict) else hasattr(node, key)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    def conv(node):
        strides = tuple(int(s) for s in field(node, "strides"))
        padding = tuple(tuple(int(p) for p in pair)
                        for pair in field(node, "padding"))
        if not has(node, "w_scale"):
            return FoldedConv(w=t(field(node, "w")), b=t(field(node, "b")),
                              strides=strides, padding=padding)
        w, kernel = _pack(t(field(node, "w")))
        return QConv(w=w, w_scale=t(field(node, "w_scale")),
                     b=t(field(node, "b")),
                     x_scale=t(field(node, "x_scale")).reshape(()),
                     kernel=kernel, strides=strides, padding=padding)

    head = tree["head"]
    return {
        "stem": conv(tree["stem"]),
        "blocks": [[{k: conv(v) for k, v in blk.items()} for blk in stage]
                   for stage in tree["blocks"]],
        "head": {k: {"weight": t(np.asarray(head[k]["kernel"]).T),
                     "bias": t(head[k]["bias"])} for k in HEADS},
    }
