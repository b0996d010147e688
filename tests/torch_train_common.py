"""Shared inputs of the HMR training parity tests
(``test_torch_hmr_train*.py``): ``tpubody``'s HMR at full depth on 64^2
images, batch 2, ``params.synthetic(24, 200)``, with Flax's dropout
neutralised in the test process (``flax.linen.intercept_methods``;
nothing in ``tpubody`` is edited) and the port's dropout rate set to 0.

Both sides compute in float64 (``jax.enable_x64`` around
every JAX call, ``HMR(dtype=float64)``; the port's model ``.double()``).
In fp32 the comparison says little: train-mode BatchNorm over 8 to 128
values a channel makes the step ill-conditioned, so fp32 rounding alone
moves the gradients by up to 15% of a tensor's largest (the port's fp32
gradients against its own float64 ones, measured on these inputs) in
either package.  ``tpubody``'s IEF heads stay in fp32 (its
``decpose``/``decshape``/``deccam`` are fp32 by construction), which
bounds the agreement at about 1e-6.

Flax variables come from ``shape_init`` with the BatchNorm affine
parameters and running statistics perturbed by seeded numpy noise, so a
swap in a converter shows.  ``value_and_grad`` of ``tpubody``'s
``loss_fn`` is jitted once per module (about 7 s of XLA:CPU compile).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tpubody.models import hmr as jhmr
from tpubody.models import hmr_train as jtrain
from tpubody.models import params as jparams
from tpubody.utils.flaxtools import shape_init
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr_train as ttrain
from tpubody_torch.models import params as tparams

SIZE = 64
B = 2
LR = 1e-4


def perturb(variables, seed=0):
    """numpy copy of a Flax tree with BN affine/statistics perturbed."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1]).strip(".[]'\"")
        x = np.array(x, np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


def batch_numpy(seed=0, has_smpl=None):
    rng = np.random.default_rng(seed)
    rot = np.broadcast_to(np.eye(3), (B, 24, 3, 3)).copy()
    rot += 0.1 * rng.normal(size=rot.shape)
    return dict(
        images=rng.normal(size=(B, SIZE, SIZE, 3)),
        keypoints2d=np.concatenate(
            [rng.uniform(0, SIZE, (B, 24, 2)),
             rng.uniform(0.5, 1.0, (B, 24, 1))], -1),
        has_smpl=(np.ones(B) if has_smpl is None
                  else np.asarray(has_smpl, np.float64)),
        gt_rotmats=rot,
        gt_shape=0.5 * rng.normal(size=(B, 10)))


def jax_batch(d):
    with jax.enable_x64(True):
        return jtrain.TrainBatch(**{k: jnp.asarray(v, jnp.float64)
                                    for k, v in d.items()})


def torch_batch(d):
    return ttrain.TrainBatch(**{k: torch.as_tensor(v, dtype=torch.float64)
                                for k, v in d.items()})


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def as_f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


class JaxSide:
    """tpubody's model, synthetic body, optax.adam and the jitted
    value_and_grad of its loss_fn, in float64 with dropout neutralised."""

    def __init__(self, remat=False):
        self.model = jhmr.HMR(mean_params=jhmr.default_mean_params(),
                              n_iter=3, dtype=jnp.float64, remat=remat)
        self.variables = as_f64(perturb(shape_init(
            self.model, jnp.zeros((1, SIZE, SIZE, 3))), seed=1))
        with jax.enable_x64(True):
            self.smpl = jparams.synthetic(n_joints=24, n_verts=200, seed=0,
                                          dtype=jnp.float64)
        self.tx = optax.adam(LR)
        self._vg = jax.jit(lambda p, bs, b: jax.value_and_grad(
            jtrain.loss_fn, has_aux=True)(
                p, bs, self.model, self.smpl, b, jax.random.PRNGKey(0),
                img_size=float(SIZE)))

    def value_and_grad(self, params, batch_stats, batch):
        with jax.enable_x64(True), nn.intercept_methods(_no_dropout):
            (loss, (new_bs, parts)), grads = self._vg(params, batch_stats,
                                                      batch)
        return loss, new_bs, parts, grads

    def init_opt(self, params):
        with jax.enable_x64(True):
            return self.tx.init(params)

    def step(self, params, batch_stats, opt_state, batch):
        """tpubody's train_step, from the same value_and_grad ->
        (params, batch_stats, opt_state, loss, grads)."""
        loss, new_bs, parts, grads = self.value_and_grad(params,
                                                         batch_stats, batch)
        with jax.enable_x64(True):
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params, new_bs, opt_state, loss, grads


def port_state(variables, remat=False):
    """The port's model on the CPU in float64 from a Flax variable tree,
    dropout off, in a fresh TrainState."""
    model = thmr.HMR(jhmr.default_mean_params(), remat=remat).double()
    model.load_state_dict(thmr.from_flax_variables(variables))
    model = thmr.to_compute(model, torch.float64, torch.device("cpu"))
    model.drop.p = 0.0
    return ttrain.create_train_state(model, lr=LR)


def port_smpl():
    return tparams.synthetic(n_joints=24, n_verts=200, seed=0,
                             dtype=torch.float64)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
