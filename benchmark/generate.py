"""The load generator: inputs of a traffic mix, drawn from the run's seed.

A mix is a data file, ``benchmark/traffic/<mix>.json``.  Its ``loop`` names
the driver in ``benchmark/loops/``; its ``images`` say how frames are drawn.
The frame size is the configuration's ``image_size``.

Image kinds:

``smooth_fields``
    Normalised NHWC float32 frames, each a bilinear upsampling of a coarse
    ``grid`` x ``grid`` x 3 Gaussian field (std ``field_scale``) plus
    per-pixel Gaussian noise (std ``noise_scale``), then a contrast of its
    own (log-normal, ``contrast_scale``) and a colour offset of its own
    (std ``offset_scale`` a channel).  Frames differ in structure, contrast
    and colour, so different frames give the model clearly different
    features, as photographs do.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import seeding


@torch.no_grad()
def images(spec: dict, n: int, size: int, seed: int, stream: str,
           device) -> torch.Tensor:
    """(n, size, size, 3) float32 frames on ``device``."""
    if spec["kind"] != "smooth_fields":
        raise ValueError(f"unknown image kind {spec['kind']!r}")
    gen = seeding.generator(seed, stream, device)
    grid = int(spec["grid"])
    coarse = spec["field_scale"] * torch.randn(
        (n, 3, grid, grid), generator=gen, device=device)
    field = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False)
    field += spec["noise_scale"] * torch.randn(
        (n, 3, size, size), generator=gen, device=device)
    frame = torch.randn((n, 4, 1, 1), generator=gen, device=device)
    field *= torch.exp(spec["contrast_scale"] * frame[:, :1])
    field += spec["offset_scale"] * frame[:, 1:]
    return field.permute(0, 2, 3, 1).contiguous()


def host_batches(mix: dict, image_size: int, seed: int,
                 device) -> List[np.ndarray]:
    """The mix's distinct batches as host numpy arrays, made on ``device``
    and copied back."""
    return [images(mix["images"], mix["batch"], image_size, seed,
                   f"traffic.batch{i}", device).cpu().numpy()
            for i in range(mix["distinct_batches"])]
