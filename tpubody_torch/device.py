"""Device resolution shared by the entry points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present.  There is no silent move to the CPU: callers
    that want the CPU pass ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array (a
    tensor's dtype kept)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
