"""Fitting priors: GMoF robustifier, L2, elbow/knee angle prior, GMM pose
prior (port of ``tpubody.fit.priors``).

Every function takes arbitrary leading batch dimensions and reduces only
over its own trailing axes, so a batch of fitting lanes evaluates in one
call and no lane's value depends on another's:

  * ``gmof``: Geman-McClure robustifier x^2 -> rho^2 * x^2/(x^2+rho^2),
  * ``l2_prior``: sum of squares over the last axis,
  * ``angle_prior``: exp(+-theta)^2 on the elbow/knee bend components
    (body-pose indices 52,55,9,12 without global orient),
  * ``max_mixture_prior``: negative log of the max-likelihood mixture
    component of a GMM over the body pose, min over components of
    0.5*(x-mu)^T P (x-mu) - log(w').  ``load_gmm`` reads the SMPLify
    pickle; ``synthetic_gmm`` is the same deterministic stand-in as
    ``tpubody``'s (the same numpy generator, so bit-equal).
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from tpubody_torch.device import DeviceLike


def gmof(residual: torch.Tensor, rho: float = 100.0) -> torch.Tensor:
    sq = residual ** 2
    return (sq / (sq + rho ** 2)) * rho ** 2


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (...,) sum of squares."""
    return torch.sum(x ** 2, dim=-1)


# Body-pose (69-dim, no global orient) indices of the bend components:
# left elbow z, right elbow z, left knee x, right knee x; signs chosen so a
# natural bend decreases the prior.
ANGLE_PRIOR_IDXS = np.array([55, 58, 12, 15]) - 3
ANGLE_PRIOR_SIGNS = np.array([1.0, -1.0, -1.0, -1.0])


_ANGLE_TABLES: dict = {}


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """body_pose: (..., 63 or 69).  Returns (..., 4) penalties."""
    key = (body_pose.device, body_pose.dtype)
    if key not in _ANGLE_TABLES:   # on the device once (CUDA graphs),
        with torch.inference_mode(False):   # saveable for backward later
            _ANGLE_TABLES[key] = (
                torch.as_tensor(ANGLE_PRIOR_IDXS, device=body_pose.device),
                torch.as_tensor(ANGLE_PRIOR_SIGNS, dtype=body_pose.dtype,
                                device=body_pose.device))
    idx, signs = _ANGLE_TABLES[key]
    comp = body_pose[..., idx]
    return torch.exp(comp * signs) ** 2


class GMMPrior(NamedTuple):
    means: torch.Tensor        # (K, D)
    precisions: torch.Tensor   # (K, D, D)
    log_norm: torch.Tensor     # (K,) -log(w_k * det-normalizer)


def _gmm(means, precisions, log_norm, dtype, device) -> GMMPrior:
    return GMMPrior(
        means=torch.as_tensor(np.asarray(means), dtype=dtype, device=device),
        precisions=torch.as_tensor(np.asarray(precisions), dtype=dtype,
                                   device=device),
        log_norm=torch.as_tensor(np.asarray(log_norm), dtype=dtype,
                                 device=device))


def synthetic_gmm(n_components: int = 8, dim: int = 69, seed: int = 0,
                  device: DeviceLike = "cpu") -> GMMPrior:
    """Deterministic stand-in GMM centered near zero pose."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=0.1, size=(n_components, dim))
    means[0] = 0.0
    prec = np.tile(np.eye(dim) * 4.0, (n_components, 1, 1))
    weights = np.full(n_components, 1.0 / n_components)
    log_norm = -np.log(weights)
    return _gmm(means, prec, log_norm, torch.float32, device)


def load_gmm(path: str, dtype=torch.float32,
             device: DeviceLike = "cpu") -> GMMPrior:
    """Load the SMPLify GMM pickle format (keys: means, covars, weights).
    Unpickling runs code: load only files from a trusted source."""
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if hasattr(gmm, "means_"):
        means, covars, weights = gmm.means_, gmm.covars_, gmm.weights_
    else:
        means, covars, weights = gmm["means"], gmm["covars"], gmm["weights"]
    means = np.asarray(means, np.float64)
    covars = np.asarray(covars, np.float64)
    weights = np.asarray(weights, np.float64)
    precisions = np.stack([np.linalg.inv(c) for c in covars])
    D = means.shape[1]
    dets = np.array([np.linalg.det(c) for c in covars])
    log_norm = -(np.log(weights) - 0.5 * (np.log(dets)
                                          + D * np.log(2 * np.pi)))
    return _gmm(means, precisions, log_norm, dtype, device)


def max_mixture_prior(body_pose: torch.Tensor, gmm: GMMPrior) -> torch.Tensor:
    """NLL of the best mixture component: body_pose (..., D) -> (...,)."""
    diff = body_pose[..., None, :] - gmm.means           # (..., K, D)
    mahal = 0.5 * torch.einsum("...kd,kde,...ke->...k", diff,
                               gmm.precisions, diff)
    return torch.min(mahal + gmm.log_norm, dim=-1).values
