"""Seeded weights of HMR with a ResNet-50 backbone, made on the device.

Names follow the published models (torchvision's ResNet-50 and SPIN's HMR:
``conv1``, ``bn1``, ``layer{1..4}.{j}.conv{1..3}``, ``downsample.0/1``,
``fc1``, ``fc2``, ``decpose``, ``decshape``, ``deccam``).  Trained weights are
not in the repository; these stand in for them at the same shapes, with
distributions chosen so that activations keep their scale through the
network and different images give clearly different poses:

* convolutions He-normal, std sqrt(2 / fan_in);
* BatchNorm scale U(0.5, 1.5) (U(0.1, 0.4) on each block's last, as in a
  trained ResNet), bias N(0, 0.1), running mean N(0, 0.1), running variance
  U(0.5, 1.5);
* fc1 and fc2 LeCun-normal, bias 0; the decoders normal with std
  ``DECODER_GAIN / sqrt(1024)`` less each row's mean, bias 0: a row that
  sums to zero leaves an output unmoved by the part of the hidden
  activations that all images share, so the mean parameters stay near the
  answer for an average image and the images move it from there.

All values come from three generator calls on the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import seeding

STAGE_FEATURES = (64, 128, 256, 512)
DECODER_GAIN = 0.03
Shape = Tuple[int, ...]


def conv_shapes(stage_sizes) -> List[Tuple[str, Shape]]:
    out = [("conv1", (64, 3, 7, 7))]
    c_in = 64
    for i, (n_blocks, f) in enumerate(zip(stage_sizes, STAGE_FEATURES)):
        for j in range(n_blocks):
            p = f"layer{i + 1}.{j}"
            out += [(p + ".conv1", (f, c_in, 1, 1)),
                    (p + ".conv2", (f, f, 3, 3)),
                    (p + ".conv3", (4 * f, f, 1, 1))]
            if j == 0:
                out.append((p + ".downsample.0", (4 * f, c_in, 1, 1)))
            c_in = 4 * f
    return out


def batchnorm_of(conv_name: str) -> str:
    if conv_name == "conv1":
        return "bn1"
    if conv_name.endswith("downsample.0"):
        return conv_name[:-1] + "1"
    return conv_name[:-len("conv1")] + "bn" + conv_name[-1]


def head_shapes(features: int, npose: int, nshape: int, ncam: int,
                hidden: int) -> List[Tuple[str, Shape]]:
    return [("fc1", (hidden, features + npose + nshape + ncam)),
            ("fc2", (hidden, hidden)),
            ("decpose", (npose, hidden)),
            ("decshape", (nshape, hidden)),
            ("deccam", (ncam, hidden))]


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    sizes = [math.prod(s) for _, s in shapes]
    return [t.view(s) for t, (_, s) in zip(torch.split(flat, sizes), shapes)]


@torch.no_grad()
def make(seed: int, device, stage_sizes=(3, 4, 6, 3), features: int = 2048,
         npose: int = 144, nshape: int = 10, ncam: int = 3,
         hidden: int = 1024) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, BatchNorm counters included."""
    gen = seeding.generator(seed, "hmr_r50.weights", device)
    convs = conv_shapes(stage_sizes)
    heads = head_shapes(features, npose, nshape, ncam, hidden)
    w: Dict[str, torch.Tensor] = {}

    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=gen,
                       device=device)
    for (name, shape), t in zip(convs, _split(flat, convs)):
        w[name + ".weight"] = t.mul_(math.sqrt(2.0 / math.prod(shape[1:])))

    channels = [shape[0] for _, shape in convs]
    u = torch.rand((4, sum(channels)), generator=gen, device=device)
    n = torch.randn((2, sum(channels)), generator=gen, device=device)
    for (name, _), gamma, beta, mean, var in zip(
            convs, *(torch.split(r, channels)
                     for r in (u[0], n[0], n[1], u[1]))):
        bn = batchnorm_of(name)
        last = name.endswith(".conv3")
        w[bn + ".weight"] = 0.1 + 0.3 * gamma if last else 0.5 + gamma
        w[bn + ".bias"] = 0.1 * beta
        w[bn + ".running_mean"] = 0.1 * mean
        w[bn + ".running_var"] = 0.5 + var
        w[bn + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long,
                                                     device=device)

    flat = torch.randn(sum(math.prod(s) for _, s in heads), generator=gen,
                       device=device)
    for (name, shape), t in zip(heads, _split(flat, heads)):
        if name in ("fc1", "fc2"):
            w[name + ".weight"] = t.mul_(1.0 / math.sqrt(shape[1]))
        else:
            t = t.mul_(DECODER_GAIN / math.sqrt(shape[1]))
            w[name + ".weight"] = t - t.mean(dim=1, keepdim=True)
        w[name + ".bias"] = torch.zeros(shape[0], device=device)
    return w


def served(weights: Dict[str, torch.Tensor],
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights in the type they are served in: the convolutions, fc1
    and fc2 in ``dtype``, the rest float32."""
    low = ("conv", "downsample.0", "fc1.weight", "fc2.weight")
    return {k: (v.to(dtype) if v.is_floating_point()
                and any(p in k for p in low) else v)
            for k, v in weights.items()}
