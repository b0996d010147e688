"""Batched L-BFGS minimizer with a strong-Wolfe zoom line search (port of
``tpubody.fit.lbfgs``).

``tpubody`` builds its minimizer on ``optax.lbfgs`` (memory 10, scaled
initial preconditioner) with ``optax.scale_by_zoom_linesearch(
max_linesearch_steps=20)`` inside one ``lax.while_loop``, and fits many
frames by ``jax.vmap`` over it.  This module is that algorithm written out
on tensors whose leading axis is the *lane* (one frame x orientation
candidate each):

  * every lane carries its own L-BFGS memory, line-search state and
    ``done`` flag; a lane that has stopped does not move while the others
    iterate (the semantics of a vmapped while_loop);
  * the two-loop recursion is optax's ``_precondition_by_lbfgs``, with the
    first step's scale the capped reciprocal gradient norm;
  * the line search is optax's ``zoom_linesearch`` (Nocedal and Wright
    algorithms 3.5/3.6 with Hager-Zhang's approximate decrease test):
    interval search, then cubic/quadratic/bisection zoom, a safeguard step
    when it fails, and the initial guess ``"keep"`` (the previous step's
    size), which is ``scale_by_zoom_linesearch``'s own default;
  * the value and gradient at an accepted point are those the line search
    computed there (``optax.value_and_grad_from_state``), so the objective
    is evaluated only inside the line search after the first point;
  * the stopping rules are ``tpubody``'s: relative loss change below
    ``ftol``, max |g| below ``gtol``, or a non-finite loss or parameter,
    which keeps the previous parameters and loss.

Where XLA evaluates both branches of a ``lax.cond`` under ``vmap`` (two
objective evaluations a line-search step), this port picks each lane's
trial step first and evaluates the objective once for all lanes.

The loop is driven from the host: one device-to-host read a line-search
step (does any lane still search?) and one an iteration (is any lane still
running?).  ``stats``, when given, counts iterations, objective
evaluations, line-search steps and those reads.  Given a graph cache on
CUDA tensors, the objective's value and gradient are captured once as a
CUDA graph (after two eager warm-up evaluations) and replayed for every
evaluation: the same kernels, without the host's cost of launching a
thousand small ones each time.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
# optax.scale_by_zoom_linesearch's defaults.
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0


class MinimizeResult(NamedTuple):
    params: Any                 # same structure as x0, (B, ...) leaves
    loss: torch.Tensor          # (B,)
    n_iters: torch.Tensor       # (B,) int32
    converged: torch.Tensor     # (B,) bool


class _Flat:
    """A tensor or a flat dict of (B, ...) tensors <-> one (B, D) tensor
    (dict keys in sorted order, as ``jax.tree_util`` orders them)."""

    def __init__(self, x0):
        self.keys = None if isinstance(x0, torch.Tensor) else sorted(x0)
        leaves = [x0] if self.keys is None else [x0[k] for k in self.keys]
        self.shapes = [tuple(t.shape[1:]) for t in leaves]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]

    def flat(self, x) -> torch.Tensor:
        leaves = [x] if self.keys is None else [x[k] for k in self.keys]
        return torch.cat([t.reshape(t.shape[0], -1) for t in leaves], dim=1)

    def unflat(self, v: torch.Tensor):
        parts = torch.split(v, self.sizes, dim=1)
        leaves = [p.reshape((v.shape[0],) + s)
                  for p, s in zip(parts, self.shapes)]
        return leaves[0] if self.keys is None else dict(zip(self.keys,
                                                            leaves))


def _count(stats: Optional[Dict[str, int]], key: str, n: int = 1) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _any(mask: torch.Tensor, stats) -> bool:
    _count(stats, "host_syncs")
    return bool(mask.any())


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(c[:, None] if a.dim() == 2 else c, a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax ``_cubicmin``; NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = (value_step - value_init
                    - APPROX_DEC_RTOL * torch.abs(value_init))
    approx = torch.maximum(approx, delta_values)
    dec = torch.minimum(approx, dec)
    dec = torch.clamp(dec, min=0.0)
    return torch.where(torch.isnan(dec), torch.full_like(dec, float("inf")),
                       dec)


def _curvature_error(slope_step, slope_init):
    curv = torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init)
    curv = torch.clamp(curv, min=0.0)
    return torch.where(torch.isnan(curv), torch.full_like(curv,
                                                          float("inf")), curv)


# Line-search state fields, one (B,) tensor each (grads (B, D)).
_LS_FIELDS = ("stepsize", "value", "grad", "slope", "value_init",
              "slope_init", "decrease_error", "curvature_error",
              "interval_found", "done", "failed", "low", "value_low",
              "slope_low", "high", "value_high", "slope_high", "cubic_ref",
              "value_cubic_ref", "safe_stepsize", "safe_value", "safe_grad")


def _zoom_linesearch(value_and_grad, x, updates, value, grad, guess,
                     searching, max_steps, stats):
    """optax's zoom line search on every lane at once.  ``searching``
    (B,) marks the lanes that search; the others are done from the start.
    Returns (stepsize, value, grad) at the accepted point of each lane."""
    slope = _vdot(updates, grad)
    zero = torch.zeros_like(value)
    inf = torch.full_like(value, float("inf"))
    s = dict(stepsize=zero, value=value, grad=grad, slope=slope,
             value_init=value, slope_init=slope, decrease_error=inf,
             curvature_error=inf, interval_found=torch.zeros_like(searching),
             done=~searching, failed=torch.zeros_like(searching),
             low=zero, value_low=value, slope_low=slope, high=zero,
             value_high=value, slope_high=slope, cubic_ref=zero,
             value_cubic_ref=value, safe_stepsize=zero, safe_value=value,
             safe_grad=grad)
    for k in range(max_steps):
        running = ~(s["done"] | s["failed"])
        found = s["interval_found"]
        # Trial step of each lane's branch: interval search (grow the step)
        # or zoom (interpolate inside [low, high]).
        grow = (guess if k == 0 else INCREASE_FACTOR * s["stepsize"])
        low, high = s["low"], s["high"]
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        m_cubic = _cubicmin(low, s["value_low"], s["slope_low"], high,
                            s["value_high"], s["cubic_ref"],
                            s["value_cubic_ref"])
        use_cubic = (m_cubic > left + cubic_chk) & (m_cubic < right
                                                    - cubic_chk)
        m_quad = _quadmin(low, s["value_low"], s["slope_low"], high,
                          s["value_high"])
        use_quad = (~use_cubic) & (m_quad > left + quad_chk) & (
            m_quad < right - quad_chk)
        use_bisect = (~use_cubic) & (~use_quad)
        middle = torch.where(use_cubic, m_cubic, s["cubic_ref"])
        middle = torch.where(use_quad, m_quad, middle)
        middle = torch.where(use_bisect, (low + high) / 2.0, middle)
        trial = torch.where(found, middle, grow)
        trial = torch.where(running, trial, zero)

        v, g = value_and_grad(x + trial[:, None] * updates)
        _count(stats, "linesearch_steps")
        sl = _vdot(g, updates)
        dec = _decrease_error(trial, v, sl, s["value_init"], s["slope_init"])
        curv = _curvature_error(sl, s["slope_init"])
        err = torch.maximum(dec, curv)
        ok_dec = dec <= TOL
        last = (k + 1) >= max_steps

        # Interval search (algorithm 3.5).
        high_new = (dec > 0.0) | ((v >= s["value"]) & (k > 0))
        low_new = (sl >= 0.0) & (~high_new)
        a = dict(
            low=torch.where(low_new, trial, s["stepsize"]),
            value_low=torch.where(low_new, v, s["value"]),
            slope_low=torch.where(low_new, sl, s["slope"]),
            high=torch.where(low_new, s["stepsize"], trial),
            value_high=torch.where(low_new, s["value"], v),
            slope_high=torch.where(low_new, s["slope"], sl),
            safe_stepsize=torch.where(ok_dec, trial, s["safe_stepsize"]),
            safe_value=torch.where(ok_dec, v, s["safe_value"]),
            safe_grad=_where(ok_dec, g, s["safe_grad"]),
            interval_found=high_new | low_new | (err <= TOL),
            done=err <= TOL,
        )
        a["cubic_ref"] = a["low"]
        a["value_cubic_ref"] = a["value_low"]
        a["failed"] = last & ~a["done"]

        # Zoom (algorithm 3.6).
        upd_safe = ok_dec & (v < s["safe_value"])
        z_safe_step = torch.where(upd_safe, trial, s["safe_stepsize"])
        z_done = err <= TOL
        hi_mid = (dec > 0.0) | (v >= s["value_low"])
        hi_low = (sl * (high - low) >= 0.0) & (~hi_mid)
        lo_mid = ~hi_mid
        z_high = torch.where(hi_low, low, torch.where(hi_mid, trial, high))
        z_vhigh = torch.where(hi_low, s["value_low"],
                              torch.where(hi_mid, v, s["value_high"]))
        z_shigh = torch.where(hi_low, s["slope_low"],
                              torch.where(hi_mid, sl, s["slope_high"]))
        moved_high = hi_mid | hi_low
        z = dict(
            low=torch.where(lo_mid, trial, low),
            value_low=torch.where(lo_mid, v, s["value_low"]),
            slope_low=torch.where(lo_mid, sl, s["slope_low"]),
            high=z_high, value_high=z_vhigh, slope_high=z_shigh,
            cubic_ref=torch.where(moved_high, high, low),
            value_cubic_ref=torch.where(moved_high, s["value_high"],
                                        s["value_low"]),
            safe_stepsize=z_safe_step,
            safe_value=torch.where(upd_safe, v, s["safe_value"]),
            safe_grad=_where(upd_safe, g, s["safe_grad"]),
            interval_found=s["interval_found"],
            done=z_done,
            failed=(last | ((delta <= STEPSIZE_PRECISION)
                            & (z_safe_step > 0.0))) & ~z_done,
        )

        new = {key: torch.where(found if a[key].dim() == 1
                                else found[:, None], z[key], a[key])
               for key in a}
        new.update(stepsize=trial, value=v, grad=g, slope=sl,
                   value_init=s["value_init"], slope_init=s["slope_init"],
                   decrease_error=dec, curvature_error=curv)
        # A failed search falls back on the safeguard point (the best step
        # with sufficient decrease), or on no step outside the domain.
        use_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                    | torch.isinf(dec))
        new["stepsize"] = torch.where(use_safe, new["safe_stepsize"], trial)
        new["value"] = torch.where(use_safe, new["safe_value"], v)
        new["grad"] = _where(use_safe, new["safe_grad"], g)
        s = {key: (_where(running, new[key], s[key])) for key in _LS_FIELDS}
        if not _any(~(s["done"] | s["failed"]), stats):
            break
    return s["stepsize"], s["value"], s["grad"]


class _GraphedValueAndGrad:
    """``xf -> (value, grad)`` of one objective on a fixed lane count,
    captured as a CUDA graph: the input is copied into a static buffer
    and the graph replayed.  The objective must not read the host or
    copy to the card (its index tables live on the device)."""

    def __init__(self, run, x: torch.Tensor):
        self.x = x.detach().clone().requires_grad_(True)
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                run(self.x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.v, self.g = run(self.x)

    def __call__(self, xf: torch.Tensor):
        with torch.no_grad():
            self.x.copy_(xf)
        self.graph.replay()
        return self.v.clone(), self.g.clone()


def minimize(
    fun: Callable[[Any], torch.Tensor],
    x0: Any,
    maxiter: int = 30,
    ftol: float = 1e-9,
    gtol: float = 1e-9,
    memory_size: int = MEMORY_SIZE,
    max_linesearch_steps: int = MAX_LINESEARCH_STEPS,
    stats: Optional[Dict[str, int]] = None,
    graph: Optional[tuple] = None,
) -> MinimizeResult:
    """Minimize ``fun`` from ``x0`` on every lane.

    ``x0`` is a tensor or a flat dict of tensors whose leading axis is the
    lane; ``fun(params) -> (B,)`` returns each lane's loss and must mix no
    lanes (the gradient is that of the sum of the lanes' losses).
    ``maxiter`` is the iteration budget (a host int).  ``graph``: a
    ``(cache, key)`` pair to replay the objective as a CUDA graph (CUDA
    tensors only; see the module docstring), captured on first use and
    reused from ``cache[key]`` by later calls, which is right only while
    ``fun`` reads nothing but tensors whose storage stays put (its caller
    copies each call's data into them)."""
    flat = _Flat(x0)
    x = flat.flat(x0).detach()

    def run(xv):
        with torch.enable_grad():
            v = fun(flat.unflat(xv))
            (g,) = torch.autograd.grad(v.sum(), xv)
        return v.detach(), g.detach()

    graphed = None
    if graph is not None and x.is_cuda and maxiter > 0:
        cache, key = graph
        graphed = cache.get(key)
        if graphed is None or graphed.x.shape != x.shape:
            graphed = cache[key] = _GraphedValueAndGrad(run, x)
            _count(stats, "graph_captures")

    def value_and_grad(xf):
        _count(stats, "evaluations")
        if graphed is not None:
            return graphed(xf)
        return run(xf.detach().requires_grad_(True))

    B, D = x.shape
    value, grad = value_and_grad(x)
    loss = value
    n_iters = torch.zeros(B, dtype=torch.int32, device=x.device)
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    m = int(memory_size)
    mem_dw = torch.zeros((m, B, D), dtype=x.dtype, device=x.device)
    mem_du = torch.zeros_like(mem_dw)
    rho = torch.zeros((m, B), dtype=x.dtype, device=x.device)
    prev_x = prev_g = None
    lr = torch.ones_like(value)
    for it in range(max(0, int(maxiter))):
        act = ~done
        # scale_by_lbfgs: store the newest pair, then precondition.
        if it > 0:
            dw = x - prev_x
            du = grad - prev_g
            vd = _vdot(du, dw)
            mem_dw[(it - 1) % m] = dw
            mem_du[(it - 1) % m] = du
            rho[(it - 1) % m] = torch.where(vd == 0.0, torch.zeros_like(vd),
                                            1.0 / vd)
            den = _vdot(du, du)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
        else:
            scale = torch.clamp(1.0 / torch.linalg.norm(grad, dim=-1),
                                max=1.0)
        order = [(it + j) % m for j in range(m)]
        vec = grad
        alphas: List[torch.Tensor] = [None] * m
        for idx in reversed(order):
            alphas[idx] = rho[idx] * _vdot(mem_dw[idx], vec)
            vec = vec - alphas[idx][:, None] * mem_du[idx]
        vec = scale[:, None] * vec
        for idx in order:
            beta = rho[idx] * _vdot(mem_du[idx], vec)
            vec = vec + (alphas[idx] - beta)[:, None] * mem_dw[idx]
        prev_x, prev_g = x, grad
        updates = -vec

        step, new_value, new_grad = _zoom_linesearch(
            value_and_grad, x, updates, value, grad, lr, act,
            max_linesearch_steps, stats)
        new_x = x + step[:, None] * updates

        rel = torch.abs(loss - new_value) / torch.clamp(
            torch.maximum(torch.abs(loss), torch.abs(new_value)), min=1.0)
        small_step = rel < ftol
        small_grad = torch.amax(torch.abs(grad), dim=-1) < gtol
        bad = ~torch.isfinite(new_value) | ~torch.isfinite(new_x).all(dim=-1)
        keep_old = bad | done
        x = _where(keep_old, x, new_x)
        loss = torch.where(keep_old, loss, new_value)
        value = torch.where(act, new_value, value)
        grad = _where(act, new_grad, grad)
        lr = torch.where(act, step, lr)
        n_iters = n_iters + act.to(torch.int32)
        done = done | small_step | small_grad | bad
        _count(stats, "iterations")
        if not _any(~done, stats):
            break
    return MinimizeResult(params=flat.unflat(x), loss=loss, n_iters=n_iters,
                          converged=done)
