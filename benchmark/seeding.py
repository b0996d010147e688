"""Seeded random streams: every input of a run is drawn from ``--seed``.

Each part of a run (weights, body, images, the choice of outputs to check)
draws from a stream of its own, so adding a part never shifts another's
numbers.  A seed is any whole number from 0 to 2**63.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run ``seed``."""
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed {seed} is outside [0, 2**63)")
    digest = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for ``stream`` of run ``seed``."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))
