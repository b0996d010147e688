"""tpubody_torch.utils.metrics and .checkpoint: the JSONL lines equal
tpubody's MetricsLogger's except the wall-clock ``t``; pytrees and train
states round-trip bit for bit (numpy leaves come back as numpy, tensors
as tensors, NamedTuples through a template); a tpubody orbax checkpoint
restored on the JAX side and carried in as numpy gives the same HMR
outputs (relative 1e-4 of the largest, the bar of test_torch_hmr.py)."""
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpubody.models import hmr as jhmr
from tpubody.utils import checkpoint as jckpt
from tpubody.utils import metrics as jmetrics
from tpubody.utils.flaxtools import shape_init
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_train as ttrain
from tpubody_torch.utils import checkpoint as tckpt
from tpubody_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _log(mod, path):
    with mod.MetricsLogger(path) as m:
        recs = [m.log("train", step=0, loss=np.float32(0.5), lr=1e-4),
                m.log("eval", step=3, mpjpe=torch.tensor(0.25),
                      note="text", bad=object.__name__),
                m.log("plain")]
    return recs


def test_metrics_lines_match(tmp_path):
    a, b = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    want_recs = _log(jmetrics, a)
    got_recs = _log(tmetrics, b)
    want, got = jmetrics.read_jsonl(a), tmetrics.read_jsonl(b)
    assert len(got) == len(want) == 3
    for g, w, gr, wr in zip(got, want, got_recs, want_recs):
        assert {k: v for k, v in g.items() if k != "t"} == \
            {k: v for k, v in w.items() if k != "t"}
        assert "t" in g and gr == g and wr == w


def test_metrics_tensorboard_is_optional(tmp_path):
    with tmetrics.MetricsLogger(None, tb_dir=str(tmp_path / "tb")) as m:
        assert m.log("x", step=1, v=1.0)["v"] == 1.0


class _Pair(NamedTuple):
    a: np.ndarray
    b: torch.Tensor


def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)),
            "meta": {"n_keypoints": np.asarray(24),
                     "features": np.asarray(32, np.int64)},
            "arr": rng.normal(size=(5,)).astype(np.float32),
            "u8": rng.integers(0, 255, (2, 2), dtype=np.uint8),
            "list": [np.arange(3), torch.arange(4), 7, 1.5, "s"],
            "pair": _Pair(np.ones(2), torch.zeros(2))}


def _assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


def test_pytree_round_trip_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "sub" / "ckpt.pt")
    tckpt.save_pytree(path, tree)
    assert not os.path.exists(path + ".tmp")
    _assert_same(tckpt.restore_pytree(path, template=tree), tree)
    plain = tckpt.restore_pytree(path)
    assert type(plain["pair"]) is tuple          # no template: a tuple
    _assert_same(plain["meta"], tree["meta"])


def _small_state(seed):
    torch.manual_seed(seed)
    model = thmr.HMR(thmr.default_mean_params(), stage_sizes=(1, 1, 1, 1))
    thmr.init_weights(model, seed)
    model.drop.p = 0.0
    return ttrain.create_train_state(model, lr=1e-3)


def _batch():
    rng = np.random.default_rng(1)
    return ttrain.TrainBatch(
        images=torch.as_tensor(rng.normal(size=(2, 32, 32, 3)),
                               dtype=torch.float32),
        keypoints2d=torch.as_tensor(np.concatenate(
            [rng.uniform(0, 32, (2, 24, 2)), np.ones((2, 24, 1))], -1),
            dtype=torch.float32),
        has_smpl=torch.ones(2),
        gt_rotmats=torch.eye(3).expand(2, 24, 3, 3).clone(),
        gt_shape=torch.zeros(2, 10))


def test_train_state_round_trip_and_resume(tmp_path):
    """Save after 2 steps; 2 more steps from the restored state equal 2
    more steps without the save, bit for bit."""
    from tpubody_torch.models import params as tparams
    smpl = tparams.synthetic(n_joints=24, n_verts=100, seed=0)
    step = ttrain.make_train_step(smpl, img_size=32.0)
    batch = _batch()
    state = _small_state(0)
    for _ in range(2):
        state, _ = step(state, batch, None)
    path = str(tmp_path / "state.pt")
    tckpt.save_train_state(path, state)

    restored = tckpt.restore_train_state(path, _small_state(1))
    assert restored.step == 2
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for _ in range(2):
        state, m1 = step(state, batch, None)
        restored, m2 = step(restored, batch, None)
        assert torch.equal(m1["loss"], m2["loss"])
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert restored.step == state.step == 4


def test_orbax_checkpoint_carried_in(tmp_path):
    """tpubody's orbax checkpoint of HMR variables -> numpy -> the port."""
    model = jhmr.HMR(mean_params=jhmr.default_mean_params(),
                     dtype=jnp.float32)
    variables = shape_init(model, jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.01) * rng.normal(
            size=np.shape(x)).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(
        np.abs, variables["batch_stats"])
    path = str(tmp_path / "orbax")
    jckpt.save_pytree(path, variables)
    restored = jax.tree_util.tree_map(np.asarray, jckpt.restore_pytree(path))

    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(images))
    port = thmr.HMR(jhmr.default_mean_params())
    port.load_state_dict(thmr.from_flax_variables(restored))
    port = thmr.to_compute(port, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        got = port(torch.as_tensor(images))
    for k in ("pose6d", "shape", "cam"):
        w = np.asarray(getattr(want, k))
        assert np.abs(getattr(got, k).numpy() - w).max() \
            <= 1e-4 * np.abs(w).max(), k
