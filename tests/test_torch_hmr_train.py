"""tpubody_torch.models.hmr_train against tpubody.models.hmr_train: one
training step of HMR at full depth (ResNet-50, 3-step IEF) on the CPU,
64^2, batch 2, ``params.synthetic(24, 200)``, in float64 on both sides
with dropout neutralised (tests/torch_train_common.py says why float64).

Bars, each with its reason (``tpubody``'s fp32 IEF heads bound the
agreement at about 1e-6):
  * loss and its parts: relative 1e-6;
  * gradients, per tensor: max |d| <= 1e-4 * max |g| of that tensor's
    tpubody gradient;
  * BatchNorm running statistics after one step: max |d| <= 1e-6 * max
    |stat| per tensor.  The parent's BatchNorm (PyTorch's unbiased update)
    misses this by n/(n-1) on the batch variance: 8/7 at layer4, where a
    channel has 2 x 2 x 2 = 8 values;
  * parameters after one Adam step: Adam's first update is about
    -lr * sign(g), so where |g| is at rounding level the sign may differ
    between packages; the update is compared where |g| > 1e-3 * max |g| of
    the tensor, within 1e-3 * lr.
"""
import numpy as np
import pytest
import torch

from tests import torch_train_common as C
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_train as ttrain

torch.set_num_threads(1)


LOSS_REL = 1e-6
GRAD_REL = 1e-4
STAT_REL = 1e-6
STEP_MASK = 1e-3
STEP_ATOL = 1e-3 * C.LR


@pytest.fixture(scope="module")
def jax_side():
    return C.JaxSide()


@pytest.fixture(scope="module")
def one_step(jax_side):
    """Both packages' first step on the same variables and batch."""
    batch = C.batch_numpy(seed=0)
    v = jax_side.variables
    loss, new_bs, parts, grads = jax_side.value_and_grad(
        v["params"], v["batch_stats"], C.jax_batch(batch))
    new_params, new_bs, _, loss, grads = jax_side.step(
        v["params"], v["batch_stats"], jax_side.init_opt(v["params"]),
        C.jax_batch(batch))
    want = dict(
        loss=float(loss), parts={k: float(x) for k, x in parts.items()},
        grads=thmr.from_flax_variables({"params": C.as_f64(grads)}),
        stats=thmr.from_flax_variables({"params": v["params"],
                       "batch_stats": C.as_f64(new_bs)}),
        params=thmr.from_flax_variables({"params": C.as_f64(new_params)}))

    state = C.port_state(v)
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    state.optimizer.zero_grad()
    total, got_parts = ttrain.loss_fn(state.model, C.port_smpl(),
                                      C.torch_batch(batch), None,
                                      img_size=float(C.SIZE))
    total.backward()
    grads_t = {k: p.grad.detach().clone()
               for k, p in state.model.named_parameters()}
    state.optimizer.step()
    got = dict(loss=float(total.detach()),
               parts={k: float(x) for k, x in got_parts.items()},
               grads=grads_t, before=before,
               sd={k: x.detach().clone()
                   for k, x in state.model.state_dict().items()})
    return want, got


def test_loss_and_parts_match(one_step):
    want, got = one_step
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert set(got["parts"]) == set(want["parts"]) == {"kp", "pose", "shape"}
    for k in want["parts"]:
        assert abs(got["parts"][k] - want["parts"][k]) \
            <= LOSS_REL * abs(want["parts"][k]), k


def test_gradients_match_per_tensor(one_step):
    want, got = one_step
    assert set(got["grads"]) == set(want["grads"])
    worst = max((C.rel(got["grads"][k].numpy(), w.numpy()), k)
                for k, w in want["grads"].items())
    assert worst[0] <= GRAD_REL, worst


def test_batchnorm_statistics_after_one_step(one_step):
    """The repaired fault: Flax folds the biased batch variance into the
    running average (momentum 0.9); PyTorch's own BatchNorm2d the unbiased
    one."""
    want, got = one_step
    keys = [k for k in want["stats"] if k.endswith(("running_mean",
                                                    "running_var"))]
    assert len(keys) == 2 * 53
    worst = max((C.rel(got["sd"][k].numpy(), want["stats"][k].numpy()), k)
                for k in keys)
    assert worst[0] <= STAT_REL, worst
    # every BatchNorm was updated exactly once
    tracked = {int(got["sd"][k]) for k in got["sd"]
               if k.endswith("num_batches_tracked")}
    assert tracked == {1}


def test_parameters_after_one_adam_step(one_step):
    want, got = one_step
    for k, w in want["params"].items():
        g = want["grads"][k].numpy()
        mask = np.abs(g) > STEP_MASK * np.abs(g).max()
        d_want = w.numpy() - got["before"][k].numpy()
        d_got = got["sd"][k].numpy() - got["before"][k].numpy()
        assert mask.any(), k
        np.testing.assert_allclose(d_got[mask], d_want[mask], rtol=0,
                                   atol=STEP_ATOL, err_msg=k)


def test_has_smpl_masking_matches(jax_side):
    """has_smpl = 0 drops an example from the parameter losses; with none
    labelled they are 0 on both sides."""
    v = jax_side.variables
    for has in ([1.0, 0.0], [0.0, 0.0]):
        batch = C.batch_numpy(seed=2, has_smpl=has)
        loss, _, parts, _ = jax_side.value_and_grad(
            v["params"], v["batch_stats"], C.jax_batch(batch))
        state = C.port_state(v)
        total, got = ttrain.loss_fn(state.model, C.port_smpl(),
                                    C.torch_batch(batch), None,
                                    img_size=float(C.SIZE))
        assert abs(float(total) - float(loss)) <= LOSS_REL * float(loss)
        for k in ("pose", "shape"):
            assert abs(float(got[k]) - float(parts[k])) \
                <= LOSS_REL * max(abs(float(parts[k])), 1e-30), (has, k)
        if not any(has):
            assert float(got["pose"]) == 0.0 and float(got["shape"]) == 0.0


def test_train_step_updates_in_place_and_counts(jax_side):
    state = C.port_state(jax_side.variables)
    step = ttrain.make_train_step(C.port_smpl(), img_size=float(C.SIZE))
    batch = C.torch_batch(C.batch_numpy(seed=3))
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch, None)
        losses.append(float(metrics["loss"]))
    assert set(metrics) == {"loss", "kp", "pose", "shape"}
    assert state.step == 3
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_remat_equals_no_remat_statistics_included(jax_side):
    """remat recomputes every bottleneck in backward; the recomputation
    must not update the BatchNorm statistics a second time."""
    batch = C.torch_batch(C.batch_numpy(seed=4))
    out = {}
    for remat in (False, True):
        state = C.port_state(jax_side.variables, remat=remat)
        state.model.train()
        total, _ = ttrain.loss_fn(state.model, C.port_smpl(), batch, None,
                                  img_size=float(C.SIZE))
        total.backward()
        out[remat] = (float(total),
                      {k: p.grad.clone()
                       for k, p in state.model.named_parameters()},
                      {k: x.clone() for k, x in
                       state.model.state_dict().items()})
    assert out[True][0] == out[False][0]
    for k, g in out[False][1].items():
        assert C.rel(out[True][1][k].numpy(), g.numpy()) <= 1e-6, k
    for k, x in out[False][2].items():
        assert torch.equal(out[True][2][k], x), k


def test_dropout_draws_from_the_generator():
    """Train-mode dropout at rate 0.5: the same generator seed gives the
    same mask, another seed another; eval mode and p = 0 are the
    identity; train mode without a generator raises."""
    model = thmr.HMR(thmr.default_mean_params(), stage_sizes=(1, 1, 1, 1))
    model.train()
    h = torch.ones(64, 1024)

    def drop(seed):
        return model._dropout(h, torch.Generator().manual_seed(seed))

    a, b, c = drop(0), drop(0), drop(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        model._dropout(h, None)
    model.eval()
    assert model._dropout(h, None) is h
    model.train()
    model.drop.p = 0.0
    assert model._dropout(h, None) is h


def test_caches_filled_in_inference_mode_serve_autograd():
    """The device-side index tables cached per device (LBS parents, the
    fit's index and angle tables) are made outside inference mode, so a
    training step after serving in the same process can save them for
    backward ("Inference tensors cannot be saved for backward")."""
    from tpubody_torch.core import lbs
    from tpubody_torch.fit import joints, priors
    from tpubody_torch.models import smpl as tsmpl

    smpl = C.port_smpl()
    pose = torch.zeros(2, 24, 3, dtype=torch.float64)
    lbs._PARENT_INDEX.clear()
    joints._INDEX_CACHE.clear()
    priors._ANGLE_TABLES.clear()
    with torch.inference_mode():
        tsmpl.forward_batch(smpl, pose, torch.zeros(10, dtype=torch.float64))
        joints._index(np.arange(5), "cpu")
        priors.angle_prior(torch.zeros(1, 63, dtype=torch.float64))
    pose.requires_grad_(True)
    out = tsmpl.forward_batch(smpl, pose, torch.zeros(10, dtype=torch.float64))
    body = torch.zeros(1, 63, dtype=torch.float64, requires_grad=True)
    x = torch.arange(10.0, requires_grad=True)
    total = (out.verts.sum() + priors.angle_prior(body).sum()
             + x[joints._index(np.arange(5), "cpu")].sum())
    total.backward()
    assert pose.grad is not None and body.grad is not None
    assert float(x.grad.sum()) == 5.0
