"""Optimizer factory for the fitting subsystem (port of
``tpubody.fit.optim``).

Same names and knobs as ``tpubody`` (and the reference factory,
lib/Gen_SMPLH/optimizers/optim_factory.py:27-65): adam / lbfgs / lbfgsls /
rmsprop / sgd.  Both L-BFGS names map to the batched strong-Wolfe
minimizer of :mod:`tpubody_torch.fit.lbfgs`.  The first-order rules are
written out as optax writes them (``optax.adam`` / ``adamw`` /
``rmsprop`` / ``sgd``: the epsilon outside the square root for Adam,
inside it for RMSProp, momentum traced after the learning-rate scale),
not taken from ``torch.optim``, whose epsilon placement and Nesterov form
differ.  Every rule works on lanes: parameters are tensors or flat dicts of
tensors with a leading lane axis, and the loss is (B,).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from tpubody_torch.fit import lbfgs as lbfgs_lib


class FirstOrderRule(NamedTuple):
    """One optax first-order rule: ``init(x) -> state`` and
    ``update(g, state, x) -> (updates, state)`` on (B, D) tensors."""

    init: Callable[[torch.Tensor], Any]
    update: Callable[..., Any]


class Optimizer(NamedTuple):
    """``minimize(fun, x0, maxiters_op=None, stats=None, graph=None)``
    runs the named optimizer (``graph``: a ``(cache, key)`` pair under
    which L-BFGS replays its objective as a CUDA graph); ``tx`` is the
    first-order rule (None for L-BFGS)."""

    name: str
    tx: Optional[FirstOrderRule]
    minimize: Callable[..., lbfgs_lib.MinimizeResult]


def _bias_correction(moment, decay: float, count: int) -> torch.Tensor:
    # 1 - decay**count in the moment's precision, as optax computes it.
    d = torch.tensor(decay, dtype=moment.dtype)
    return moment / (1 - d ** count).to(moment.device)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> FirstOrderRule:
    """optax.adam (weight_decay 0) / optax.adamw."""
    def init(x):
        return (0, torch.zeros_like(x), torch.zeros_like(x))

    def update(g, state, x):
        count, mu, nu = state
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g ** 2 + b2 * nu
        count += 1
        u = _bias_correction(mu, b1, count) / (
            torch.sqrt(_bias_correction(nu, b2, count) + 0.0) + eps)
        if weight_decay:
            u = u + weight_decay * x
        return u * (-lr), (count, mu, nu)

    return FirstOrderRule(init, update)


def rmsprop(lr, decay=0.9, eps=1e-8, centered=False,
            momentum=None) -> FirstOrderRule:
    """optax.rmsprop (initial_scale 0, eps inside the square root, no bias
    correction), momentum traced after the learning-rate scale."""
    def init(x):
        z = torch.zeros_like(x)
        return (z, z, z)

    def update(g, state, x):
        mu, nu, trace = state
        nu = (1 - decay) * g ** 2 + decay * nu
        if centered:
            mu = (1 - decay) * g + decay * mu
            u = torch.rsqrt(nu - mu * mu + eps) * g
        else:
            u = torch.rsqrt(nu + eps) * g
        u = u * (-lr)
        if momentum is not None:
            trace = u + momentum * trace
            u = trace
        return u, (mu, nu, trace)

    return FirstOrderRule(init, update)


def sgd(lr, momentum=None, nesterov=False) -> FirstOrderRule:
    """optax.sgd: optional (Nesterov) momentum trace, then -lr."""
    def init(x):
        return torch.zeros_like(x)

    def update(g, trace, x):
        u = g
        if momentum is not None:
            trace = g + momentum * trace
            u = g + momentum * trace if nesterov else trace
        return u * (-lr), trace

    return FirstOrderRule(init, update)


def _with_scales(run, scales):
    """Per-parameter-group diagonal preconditioning by reparameterization:
    the minimizer runs in y-space where ``x = s * y`` (identity for keys
    without a scale; ``x0`` must be a flat dict of tensors)."""
    if not scales:
        return run

    def wrapped(fun, x0, **kw):
        s = {k: float(scales.get(k, 1.0)) for k in x0}
        st = {k: torch.tensor(v, dtype=torch.float32,
                              device=x0[k].device) for k, v in s.items()}
        y0 = {k: x0[k] / st[k] for k in x0}
        res = run(lambda y: fun({k: y[k] * st[k] for k in y}), y0, **kw)
        return res._replace(
            params={k: res.params[k] * st[k] for k in res.params})

    return wrapped


def _first_order_minimizer(tx: FirstOrderRule, maxiters: int):
    def run(fun, x0, maxiters_op=None, stats: Optional[Dict] = None,
            graph=None):
        """A fixed-length loop of ``maxiters`` steps whose steps past the
        budget ``maxiters_op`` (<= ``maxiters``) are no-ops; the budget is
        a host int, so those steps are skipped.  Budget 0 still reports
        fun(x0), like the L-BFGS path."""
        flat = lbfgs_lib._Flat(x0)
        x = flat.flat(x0).detach()
        budget = maxiters if maxiters_op is None else int(maxiters_op)
        state = tx.init(x)
        last = None
        for i in range(maxiters):
            live = i < budget
            if not live and i > 0:
                break
            with torch.enable_grad():
                xv = x.requires_grad_(True)
                loss = fun(flat.unflat(xv))
                (g,) = torch.autograd.grad(loss.sum(), xv)
            x = x.detach()
            last = loss.detach()
            if stats is not None:
                stats["evaluations"] = stats.get("evaluations", 0) + 1
            if not live:
                break
            updates, state = tx.update(g, state, x)
            x = x + updates
        if last is None:
            last = torch.full((x.shape[0],), float("inf"),
                              device=x.device)
        B = x.shape[0]
        return lbfgs_lib.MinimizeResult(
            params=flat.unflat(x), loss=last,
            n_iters=torch.full((B,), budget, dtype=torch.int32,
                               device=x.device),
            converged=torch.ones(B, dtype=torch.bool, device=x.device))

    return run


def create_optimizer(optim_type: str = "lbfgsls",
                     lr: float = 1e-3,
                     momentum: float = 0.9,
                     use_nesterov: bool = True,
                     beta1: float = 0.9,
                     beta2: float = 0.999,
                     epsilon: float = 1e-8,
                     weight_decay: float = 0.0,
                     centered: bool = False,
                     rmsprop_alpha: float = 0.99,
                     maxiters: int = 20,
                     gtol: float = 1e-6,
                     ftol: float = 1e-9,
                     param_scales: Any = None,
                     **_: Any) -> Optimizer:
    """Build the optimizer named by ``optim_type`` (unknown names raise
    ValueError).  ``param_scales`` (parameter-dict key -> float)
    preconditions the named groups, see :func:`_with_scales`."""
    if optim_type == "adam":
        tx = adam(lr, b1=beta1, b2=beta2, eps=epsilon,
                  weight_decay=weight_decay)
        run = _first_order_minimizer(tx, maxiters)
    elif optim_type in ("lbfgs", "lbfgsls"):
        tx = None

        def run(fun, x0, maxiters_op=None, stats=None, graph=None):
            m = maxiters if maxiters_op is None else \
                min(int(maxiters_op), maxiters)
            return lbfgs_lib.minimize(fun, x0, maxiter=m, gtol=gtol,
                                      ftol=ftol, stats=stats, graph=graph)
    elif optim_type == "rmsprop":
        tx = rmsprop(lr, decay=rmsprop_alpha, eps=epsilon,
                     centered=centered, momentum=momentum)
        run = _first_order_minimizer(tx, maxiters)
    elif optim_type == "sgd":
        tx = sgd(lr, momentum=momentum, nesterov=use_nesterov)
        run = _first_order_minimizer(tx, maxiters)
    else:
        raise ValueError(f"Optimizer {optim_type} not supported!")
    return Optimizer(optim_type, tx, _with_scales(run, param_scales))
