"""Moving a training run between the packages, and the 3D eval step:
``tpubody``'s TrainState after 2 steps carried into the port with
``from_flax_variables`` + ``from_optax_state`` takes the same third step;
``make_eval_step`` gives ``tpubody``'s MPJPE / PA-MPJPE / PVE.  Float64
on both sides, dropout neutralised (tests/torch_train_common.py says
why); the bars are those of test_torch_hmr_train.py.
"""
import jax
import numpy as np
import pytest
import torch

from tests import torch_train_common as C
from tpubody.models import hmr_train as jtrain
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_train as ttrain

torch.set_num_threads(1)

LOSS_REL = 1e-6
STAT_REL = 1e-6
STEP_MASK = 1e-3
STEP_ATOL = 1e-3 * C.LR
EVAL_REL = 1e-6


@pytest.fixture(scope="module")
def jax_side():
    return C.JaxSide()


@pytest.fixture(scope="module")
def carried(jax_side):
    """tpubody: 2 steps, then a third; the port: the state after 2 steps
    carried in, then the third."""
    v = jax_side.variables
    params, bs = v["params"], v["batch_stats"]
    opt = jax_side.init_opt(params)
    for seed in (10, 11):
        params, bs, opt, _, _ = jax_side.step(params, bs, opt,
                                              C.jax_batch(C.batch_numpy(seed)))
    batch = C.batch_numpy(12)
    p3, bs3, _, loss3, grads3 = jax_side.step(params, bs, opt,
                                              C.jax_batch(batch))

    state = C.port_state({"params": C.as_f64(params),
                          "batch_stats": C.as_f64(bs)})
    adam = jax.tree_util.tree_map(np.asarray, opt[0])
    state.optimizer.load_state_dict(
        ttrain.from_optax_state(adam, state.model, state.optimizer))
    before = {k: p.detach().clone()
              for k, p in state.model.named_parameters()}
    step = ttrain.make_train_step(C.port_smpl(), img_size=float(C.SIZE))
    state, metrics = step(state, C.torch_batch(batch), None)
    return dict(
        want_loss=float(loss3),
        want_params=thmr.from_flax_variables({"params": C.as_f64(p3)}),
        want_stats=thmr.from_flax_variables(
            {"params": C.as_f64(p3), "batch_stats": C.as_f64(bs3)}),
        grads=thmr.from_flax_variables({"params": C.as_f64(grads3)}),
        adam=adam, state=state, metrics=metrics, before=before)


def test_optax_state_carried_in(carried):
    """count, mu and nu land in the optimizer under the port's names."""
    state, adam = carried["state"], carried["adam"]
    mu = thmr.from_flax_variables({"params": C.as_f64(adam.mu)})
    opt_sd = state.optimizer.state_dict()
    names = [n for n, _ in state.model.named_parameters()]
    assert int(adam.count) == 2
    # after the third step the port's count is 3
    for i, name in enumerate(names):
        assert float(opt_sd["state"][i]["step"]) == 3.0
        assert opt_sd["state"][i]["exp_avg"].shape == mu[name].shape


def test_third_step_matches(carried):
    got = carried
    loss = float(got["metrics"]["loss"])
    assert abs(loss - got["want_loss"]) <= LOSS_REL * got["want_loss"]
    assert got["state"].step == 1      # the port counts its own steps
    sd = got["state"].model.state_dict()
    for k, w in got["want_params"].items():
        g = got["grads"][k].numpy()
        mask = np.abs(g) > STEP_MASK * np.abs(g).max()
        d_want = w.numpy() - got["before"][k].numpy()
        d_got = sd[k].numpy() - got["before"][k].numpy()
        np.testing.assert_allclose(d_got[mask], d_want[mask], rtol=0,
                                   atol=STEP_ATOL, err_msg=k)
    for k, w in got["want_stats"].items():
        if k.endswith(("running_mean", "running_var")):
            assert C.rel(sd[k].numpy(), w.numpy()) <= STAT_REL, k


def test_eval_step_matches(jax_side):
    """make_eval_step on the same variables: eval-mode model (running
    statistics), GT through the same body; has_smpl masks the means."""
    v = jax_side.variables
    eval_j = jax.jit(jtrain.make_eval_step(jax_side.model, jax_side.smpl))
    state = C.port_state(v)
    eval_t = ttrain.make_eval_step(C.port_smpl())
    for has in ([1.0, 1.0], [1.0, 0.0]):
        batch = C.batch_numpy(seed=20, has_smpl=has)
        jstate = jtrain.TrainState(params=v["params"],
                                   batch_stats=v["batch_stats"],
                                   opt_state=None, step=0)
        with jax.enable_x64(True):
            want = {k: float(x) for k, x in
                    eval_j(jstate, C.jax_batch(batch)).items()}
        got = {k: float(x) for k, x in
               eval_t(state, C.torch_batch(batch)).items()}
        assert set(got) == set(want) == {"mpjpe", "pa_mpjpe", "pve"}
        for k in want:
            assert abs(got[k] - want[k]) <= EVAL_REL * abs(want[k]), (has, k)
    assert state.model.training      # put back in train mode
