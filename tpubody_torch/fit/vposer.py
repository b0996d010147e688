"""VPoser: variational pose prior (encoder/decoder MLPs) as ``nn.Module``s
(port of ``tpubody.fit.vposer``).

Architecture parity with the reference VPoser
(lib/Gen_SMPLH/vposer/vposer_smpl.py:59-164): encoder 63 -> 512 -> 512 ->
(32 mean, 32 logvar); decoder 32 -> 512 -> 512 -> 21*6 (6D rotations) ->
rotation matrices / axis-angle via the continuous rotation decoder
(Gram-Schmidt on the two 3-vectors, read as the first two *columns*).

Weights reach the port three ways:
  * :func:`create_decoder` seeds a ``torch.Generator``; its weights are
    NOT those of ``tpubody``'s ``create_decoder`` (a flax ``PRNGKey``
    init), only of the same architecture and scale;
  * :func:`from_flax_params` copies ``tpubody``'s decoder/encoder param
    trees, given as nested dicts of numpy arrays (flax ``kernel`` is
    (in, out), ``nn.Linear.weight`` is (out, in));
  * :func:`load_torch_checkpoint` loads the reference's ``.pt`` snapshot
    (TR00_E096.pt: ``bodyprior_dec_fc1`` -> ``fc1`` and so on) straight
    into the modules.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpubody_torch.core.rotations import rot6d_to_rotmat, rotmat_to_axis_angle
from tpubody_torch.device import DeviceLike

LATENT_D = 32
N_JOINTS = 21
HIDDEN = 512


class VPoserDecoder(nn.Module):
    """latent (B, 32) -> rotmats (B, 21, 3, 3)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(LATENT_D, HIDDEN)
        self.fc2 = nn.Linear(HIDDEN, HIDDEN)
        self.out = nn.Linear(HIDDEN, N_JOINTS * 6)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.fc1(z), 0.2)
        h = F.leaky_relu(self.fc2(h), 0.2)
        out = self.out(h)
        return rot6d_to_rotmat(out.reshape(-1, N_JOINTS, 6)).reshape(
            z.shape[0], N_JOINTS, 3, 3)


class VPoserEncoder(nn.Module):
    """body pose aa (B, 63) -> (mean (B, 32), scale (B, 32)); its
    BatchNorm layers always run in inference mode (running statistics),
    as the reference encoder does at fitting time."""

    def __init__(self):
        super().__init__()
        self.bn1 = nn.BatchNorm1d(N_JOINTS * 3, eps=1e-5)
        self.fc1 = nn.Linear(N_JOINTS * 3, HIDDEN)
        self.bn2 = nn.BatchNorm1d(HIDDEN, eps=1e-5)
        self.fc2 = nn.Linear(HIDDEN, HIDDEN)
        self.mu = nn.Linear(HIDDEN, LATENT_D)
        self.logvar = nn.Linear(HIDDEN, LATENT_D)
        self.eval()

    def train(self, mode: bool = True) -> "VPoserEncoder":
        return super().train(False)

    def forward(self, pose: torch.Tensor):
        h = self.bn1(pose)
        h = F.leaky_relu(self.fc1(h), 0.2)
        h = self.bn2(h)
        h = F.leaky_relu(self.fc2(h), 0.2)
        return self.mu(h), F.softplus(self.logvar(h))


def decode_to_axis_angle(decoder: VPoserDecoder,
                         z: torch.Tensor) -> torch.Tensor:
    """latent (B, 32) -> (B, 63) axis-angle body pose (21 joints)."""
    rotmats = decoder(z)
    return rotmat_to_axis_angle(rotmats).reshape(z.shape[0], N_JOINTS * 3)


def create_decoder(seed: int = 0,
                   device: DeviceLike = "cpu") -> VPoserDecoder:
    """A decoder with seeded random weights: each layer's weight and bias
    uniform in +-1/sqrt(fan_in) (``nn.Linear``'s own bound), drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    dec = VPoserDecoder()
    with torch.no_grad():
        for layer in (dec.fc1, dec.fc2, dec.out):
            bound = 1.0 / np.sqrt(layer.in_features)
            layer.weight.copy_(torch.rand(layer.weight.shape,
                                          generator=gen) * 2 * bound - bound)
            layer.bias.copy_(torch.rand(layer.bias.shape,
                                        generator=gen) * 2 * bound - bound)
    return dec.to(device).requires_grad_(False)


def _copy_dense(layer: nn.Linear, p: Mapping[str, Any]) -> None:
    layer.weight.copy_(torch.as_tensor(np.asarray(p["kernel"]).T.copy()))
    layer.bias.copy_(torch.as_tensor(np.asarray(p["bias"])))


def from_flax_params(dec_tree: Optional[Mapping] = None,
                     enc_tree: Optional[Mapping] = None,
                     device: DeviceLike = "cpu"
                     ) -> Tuple[Optional[VPoserDecoder],
                                Optional[VPoserEncoder]]:
    """``tpubody``'s flax param trees ({"params": {"fc1": {"kernel",
    "bias"}, ...}}, encoder also {"batch_stats": ...}) as numpy -> the
    port's modules.  Either tree may be None."""
    dec = enc = None
    with torch.no_grad():
        if dec_tree is not None:
            dec = VPoserDecoder()
            p = dec_tree["params"]
            for name in ("fc1", "fc2", "out"):
                _copy_dense(getattr(dec, name), p[name])
            dec = dec.to(device).requires_grad_(False)
        if enc_tree is not None:
            enc = VPoserEncoder()
            p, s = enc_tree["params"], enc_tree["batch_stats"]
            for name in ("fc1", "fc2", "mu", "logvar"):
                _copy_dense(getattr(enc, name), p[name])
            for name in ("bn1", "bn2"):
                bn = getattr(enc, name)
                bn.weight.copy_(torch.as_tensor(np.asarray(p[name]["scale"])))
                bn.bias.copy_(torch.as_tensor(np.asarray(p[name]["bias"])))
                bn.running_mean.copy_(
                    torch.as_tensor(np.asarray(s[name]["mean"])))
                bn.running_var.copy_(
                    torch.as_tensor(np.asarray(s[name]["var"])))
            enc = enc.to(device).requires_grad_(False)
    return dec, enc


# Reference state-dict prefixes -> the port's layer names.
_DEC_NAMES = {"bodyprior_dec_fc1": "fc1", "bodyprior_dec_fc2": "fc2",
              "bodyprior_dec_out": "out"}
_ENC_NAMES = {"bodyprior_enc_bn1": "bn1", "bodyprior_enc_fc1": "fc1",
              "bodyprior_enc_bn2": "bn2", "bodyprior_enc_fc2": "fc2",
              "bodyprior_enc_mu": "mu", "bodyprior_enc_logvar": "logvar"}


_COUNTER = "num_batches_tracked"     # BatchNorm's, not a weight


def load_state_dict(state_dict: Mapping[str, Any],
                    device: DeviceLike = "cpu"
                    ) -> Tuple[VPoserDecoder, VPoserEncoder]:
    """A reference VPoser state dict -> (decoder, encoder) modules."""
    dec, enc = VPoserDecoder(), VPoserEncoder()
    for module, names in ((dec, _DEC_NAMES), (enc, _ENC_NAMES)):
        sd = {}
        for ref, ours in names.items():
            for k, v in state_dict.items():
                if k.startswith(ref + ".") and not k.endswith(_COUNTER):
                    sd[ours + k[len(ref):]] = torch.as_tensor(np.asarray(v))
        module.load_state_dict(sd, strict=False)
        missing = {k for k in module.state_dict()
                   if not k.endswith(_COUNTER)} - set(sd)
        if missing:
            raise KeyError(f"VPoser checkpoint lacks {sorted(missing)}")
    return (dec.to(device).requires_grad_(False),
            enc.to(device).requires_grad_(False))


def load_torch_checkpoint(path: str, device: DeviceLike = "cpu"
                          ) -> Tuple[VPoserDecoder, VPoserEncoder]:
    """Load a ``.pt`` VPoser snapshot.  The file is unpickled: load only
    checkpoints from a trusted source."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    return load_state_dict(sd, device=device)
