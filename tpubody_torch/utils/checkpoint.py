"""Training/model checkpoints (port of ``tpubody.utils.checkpoint``).

``tpubody`` writes orbax checkpoints, a JAX library; the port has a format
of its own: one file per checkpoint, written by ``torch.save`` and read
back by ``torch.load(weights_only=True)``, which unpickles only tensors
and plain containers (loading anything else would run arbitrary pickle
code).  A tree's numpy leaves are stored as tensors under a one-key
``{"__numpy__": tensor}`` marker and come back as numpy arrays;
NamedTuples are stored as tuples and come back as their type when a
``template`` is given.  Tensors are stored on the CPU.  A save writes a
temporary file beside the target and renames it over the target, so a
crash never leaves a half-written checkpoint.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

_NUMPY = "__numpy__"


def _pack(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray) or isinstance(tree, np.generic):
        return {_NUMPY: torch.from_numpy(np.array(tree, order="C"))}
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pack(v) for v in tree]
    if isinstance(tree, tuple):   # NamedTuples too: weights_only refuses them
        return tuple(_pack(v) for v in tree)
    return tree


def _unpack(tree: Any) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {_NUMPY}:
            return tree[_NUMPY].numpy()
        return {k: _unpack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unpack(v) for v in tree)
    return tree


def _like(template: Any, value: Any) -> Any:
    """``value`` in the container types of ``template``."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_like(t, v)
                                for t, v in zip(template, value)])
    if isinstance(template, dict):
        return {k: _like(template[k], value[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, v) for t, v in zip(template, value))
    return value


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of dicts, lists and tuples whose leaves are tensors,
    numpy arrays or Python scalars to the file ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_pack(tree), tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, template: Optional[Any] = None) -> Any:
    """Restore a tree (tensors on the CPU); pass ``template`` to get its
    container types (NamedTuples among them) back."""
    tree = _unpack(torch.load(os.path.abspath(path), map_location="cpu",
                              weights_only=True))
    return tree if template is None else _like(template, tree)


def save_train_state(path: str, state) -> None:
    """Save an ``hmr_train.TrainState``: the model's state_dict (weights
    and BatchNorm statistics), the optimizer's and the step."""
    save_pytree(path, {"model": state.model.state_dict(),
                       "optimizer": state.optimizer.state_dict(),
                       "step": int(state.step)})


def restore_train_state(path: str, template):
    """Load a saved train state into ``template`` (a ``TrainState`` of the
    same architecture, on any device) and return it with the saved step."""
    raw = restore_pytree(path)
    template.model.load_state_dict(raw["model"])
    template.optimizer.load_state_dict(raw["optimizer"])
    return template._replace(step=int(raw["step"]))
