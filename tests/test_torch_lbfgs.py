"""tpubody_torch.fit.lbfgs and fit.optim against tpubody.fit.lbfgs /
tpubody.fit.optim (optax), iterate by iterate.

Functions in fp32: a quadratic of condition 100, 2-D Rosenbrock and a
10-D coupled function.  For k = 1..10 iterations the parameters must
agree within 1e-5 abs or 1e-4 rel, with the same ``n_iters`` and
``converged``.  Lanes of one batch stop at their own iteration and stay
frozen (the semantics of tpubody's vmapped while_loop).  The first-order
rules (adam, adamw, rmsprop, sgd) are held to optax over 50 steps.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubody.fit import lbfgs as jlbfgs
from tpubody.fit import optim as joptim
from tpubody_torch.fit import lbfgs as tlbfgs
from tpubody_torch.fit import optim as toptim

torch.set_num_threads(1)

ATOL = 1e-5
RTOL = 1e-4

A = np.diag(np.logspace(0.0, 2.0, 6)).astype(np.float32)
R = np.random.default_rng(0).normal(size=(10, 10)).astype(np.float32) / 4


def quad_j(x):
    return 0.5 * jnp.dot(x, jnp.asarray(A) @ x)


def quad_t(x):
    return 0.5 * torch.sum(x * (x @ torch.as_tensor(A).T), dim=-1)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def rosen_t(x):
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1 - x[:, :-1]) ** 2, dim=-1)


def coupled_j(x):
    y = jnp.asarray(R) @ x
    return jnp.sum(jnp.log1p(y ** 2)) + 0.1 * jnp.sum((x - 1.0) ** 2) \
        + jnp.sum((x[1:] - x[:-1]) ** 2)


def coupled_t(x):
    y = x @ torch.as_tensor(R).T
    return torch.sum(torch.log1p(y ** 2), dim=-1) \
        + 0.1 * torch.sum((x - 1.0) ** 2, dim=-1) \
        + torch.sum((x[:, 1:] - x[:, :-1]) ** 2, dim=-1)


FUNCS = {
    "quadratic": (quad_j, quad_t, np.ones(6, np.float32)),
    "rosenbrock": (rosen_j, rosen_t, np.array([-1.2, 1.0], np.float32)),
    "coupled10": (coupled_j, coupled_t,
                  np.linspace(-2.0, 3.0, 10).astype(np.float32)),
}


@functools.lru_cache(maxsize=None)
def _jax_minimize(name):
    fj = FUNCS[name][0]
    # maxiter is a traced operand of tpubody's while_loop: one compile.
    return jax.jit(lambda x, m: jlbfgs.minimize(fj, x, maxiter=m))


def close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", range(1, 11))
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_iterates_match(name, k):
    _, ft, x0 = FUNCS[name]
    rj = _jax_minimize(name)(jnp.asarray(x0), jnp.asarray(k))
    rt = tlbfgs.minimize(ft, torch.as_tensor(x0)[None], maxiter=k)
    close(rj.params, rt.params[0])
    close(rj.loss, rt.loss[0])
    assert int(rj.n_iters) == int(rt.n_iters[0])
    assert bool(rj.converged) == bool(rt.converged[0])


def test_lanes_stop_at_their_own_iteration():
    """Four lanes of sum(cosh(x - t)) from different starts with gtol
    1e-3: they stop at different iterations, each as tpubody's vmapped
    minimizer stops it, and a stopped lane stays where it stopped."""
    t = np.array([1.0, -2.0, 0.5], np.float32)
    x0 = np.stack([t + 1e-5, t + 0.3, t - 1.5, t + 4.0]).astype(np.float32)

    def fj(x):
        return jnp.sum(jnp.cosh(x - jnp.asarray(t)))

    def ft(x):
        return torch.sum(torch.cosh(x - torch.as_tensor(t)), dim=-1)

    rj = jax.jit(jax.vmap(lambda x: jlbfgs.minimize(
        fj, x, maxiter=20, gtol=1e-3)))(jnp.asarray(x0))
    rt = tlbfgs.minimize(ft, torch.as_tensor(x0), maxiter=20, gtol=1e-3)
    np.testing.assert_array_equal(np.asarray(rj.n_iters), rt.n_iters)
    np.testing.assert_array_equal(np.asarray(rj.converged), rt.converged)
    close(rj.params, rt.params)
    n = rt.n_iters.numpy()
    assert len(set(n.tolist())) > 1, n
    for i in range(4):       # frozen: the lane alone with its own budget
        alone = tlbfgs.minimize(ft, torch.as_tensor(x0[i:i + 1]),
                                maxiter=int(n[i]), gtol=1e-3)
        assert torch.equal(alone.params[0], rt.params[i])


def test_lbfgs_dict_params_and_stats():
    """A dict of parameter groups flattens in sorted key order; the stats
    count iterations, evaluations, line-search steps and host reads."""
    def fj(p):
        return jnp.sum((p["b"] - 2.0) ** 2) + jnp.sum(
            jnp.cosh(p["a"] - p["b"][0]))

    def ft(p):
        return torch.sum((p["b"] - 2.0) ** 2, dim=-1) + torch.sum(
            torch.cosh(p["a"] - p["b"][:, :1]), dim=-1)

    x0 = {"a": np.array([0.5, -1.0, 3.0], np.float32),
          "b": np.array([1.0, 4.0], np.float32)}
    rj = jax.jit(lambda x: jlbfgs.minimize(fj, x, maxiter=8))(
        {k: jnp.asarray(v) for k, v in x0.items()})
    stats = {}
    rt = tlbfgs.minimize(ft, {k: torch.as_tensor(v)[None]
                              for k, v in x0.items()}, maxiter=8,
                         stats=stats)
    for key in x0:
        close(rj.params[key], rt.params[key][0])
    assert stats["iterations"] == int(rt.n_iters[0])
    assert stats["evaluations"] == stats["linesearch_steps"] + 1
    assert stats["host_syncs"] >= stats["iterations"]


@pytest.mark.parametrize("budget", [0, 1, 3, 999])
def test_lbfgs_budget(budget):
    """maxiters_op truncates the L-BFGS loop (0 passes x0 through with
    fun(x0); above the static cap clamps to it), as in tpubody."""
    def fj(x):
        return jnp.sum(jnp.cosh(x - jnp.asarray([1.0, -2.0, 3.0])))

    def ft(x):
        return torch.sum(torch.cosh(x - torch.tensor([1.0, -2.0, 3.0])),
                         dim=-1)

    x0 = np.zeros(3, np.float32)
    jo = joptim.create_optimizer("lbfgsls", maxiters=5)
    to = toptim.create_optimizer("lbfgsls", maxiters=5)
    rj = jax.jit(lambda x, m: jo.minimize(fj, x, maxiters_op=m))(
        jnp.asarray(x0), jnp.asarray(budget))
    rt = to.minimize(ft, torch.as_tensor(x0)[None], maxiters_op=budget)
    close(rj.params, rt.params[0])
    close(rj.loss, rt.loss[0])
    assert int(rj.n_iters) == int(rt.n_iters[0]) == min(budget, 5)


FIRST_ORDER = {
    "adam": dict(optim_type="adam", lr=0.05),
    "adamw": dict(optim_type="adam", lr=0.05, weight_decay=0.01),
    "rmsprop": dict(optim_type="rmsprop", lr=0.01),
    "rmsprop_centered": dict(optim_type="rmsprop", lr=0.01, centered=True),
    "sgd_nesterov": dict(optim_type="sgd", lr=0.01),
    "sgd_plain": dict(optim_type="sgd", lr=0.01, momentum=0.5,
                      use_nesterov=False),
}


@pytest.mark.parametrize("rule", sorted(FIRST_ORDER))
def test_first_order_rules_match_optax(rule):
    kw = FIRST_ORDER[rule]
    _, ft, x0 = FUNCS["coupled10"]
    fj = FUNCS["coupled10"][0]
    jo = joptim.create_optimizer(maxiters=50, **kw)
    to = toptim.create_optimizer(maxiters=50, **kw)
    rj = jax.jit(lambda x: jo.minimize(fj, x))(jnp.asarray(x0))
    rt = to.minimize(ft, torch.as_tensor(x0)[None])
    close(rj.params, rt.params[0])
    close(rj.loss, rt.loss[0])


@pytest.mark.parametrize("budget", [0, 7])
def test_first_order_budget_masks_steps(budget):
    _, ft, x0 = FUNCS["coupled10"]
    fj = FUNCS["coupled10"][0]
    jo = joptim.create_optimizer("sgd", lr=0.01, maxiters=30)
    to = toptim.create_optimizer("sgd", lr=0.01, maxiters=30)
    rj = jax.jit(lambda x, m: jo.minimize(fj, x, maxiters_op=m))(
        jnp.asarray(x0), jnp.asarray(budget))
    rt = to.minimize(ft, torch.as_tensor(x0)[None], maxiters_op=budget)
    close(rj.params, rt.params[0])
    close(rj.loss, rt.loss[0])
    assert int(rt.n_iters[0]) == budget


@pytest.mark.parametrize("optim_type", ["lbfgsls", "adam"])
def test_param_scales(optim_type):
    """x = s * y reparameterisation of named groups, as tpubody's."""
    def fj(p):
        return jnp.sum((p["a"] * p["b"] - 1.5) ** 2) + jnp.sum(p["b"] ** 2)

    def ft(p):
        return torch.sum((p["a"] * p["b"] - 1.5) ** 2, dim=-1) + \
            torch.sum(p["b"] ** 2, dim=-1)

    x0 = {"a": np.array([0.3, 2.0], np.float32),
          "b": np.array([1.0, -0.5], np.float32)}
    kw = dict(lr=0.05, maxiters=6, param_scales={"a": 8.0})
    jo = joptim.create_optimizer(optim_type, **kw)
    to = toptim.create_optimizer(optim_type, **kw)
    rj = jax.jit(lambda x: jo.minimize(fj, x))(
        {k: jnp.asarray(v) for k, v in x0.items()})
    rt = to.minimize(ft, {k: torch.as_tensor(v)[None]
                          for k, v in x0.items()})
    for key in x0:
        close(rj.params[key], rt.params[key][0])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        toptim.create_optimizer("newton")
