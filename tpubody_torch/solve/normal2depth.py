"""Normal-map -> depth-map integration by matrix-free conjugate gradient
(port of ``tpubody.solve.normal2depth``).

The reference assembles a giant sparse finite-difference system and calls
scipy CG (lib/Normal2Depth.py:31-124: A = [Dx; Dy] forward differences over
the full image, b = [-nx/nz; -ny/nz] with normals zeroed outside the mask,
solve AtA z = At b).  At 1024x1024 that is a ~1M-unknown system.

AtA of that stencil is exactly a 5-point Laplacian with Neumann-style
boundaries, so no matrix is built: the operator is two shifts and two
subtracts per direction, and the solve is a preconditioned CG written out
here.  Front and back integrate in a single batched CG (leading batch
axis).  The loop runs eagerly: every iteration is a few hundred small
launches (the V-cycle) and one read of its exit flags from the device.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tpubody_torch.image import morphology


def _dx(z: torch.Tensor) -> torch.Tensor:
    """Forward difference along x: (..., H, W) -> (..., H, W-1)."""
    return z[..., :, 1:] - z[..., :, :-1]


def _dy(z: torch.Tensor) -> torch.Tensor:
    return z[..., 1:, :] - z[..., :-1, :]


def _div_x(g: torch.Tensor) -> torch.Tensor:
    """Adjoint of _dx (negative divergence): out[j] = g[j-1] - g[j],
    g has W-1 columns; out has W."""
    return F.pad(g, (1, 0)) - F.pad(g, (0, 1))


def _div_y(g: torch.Tensor) -> torch.Tensor:
    return F.pad(g, (0, 0, 1, 0)) - F.pad(g, (0, 0, 0, 1))


def laplacian_AtA(z: torch.Tensor) -> torch.Tensor:
    """AtA z for A = [Dx; Dy] forward differences (..., H, W)."""
    return _div_x(_dx(z)) + _div_y(_dy(z))


def _degree(H: int, W: int, dtype, device=None) -> torch.Tensor:
    """diag(AtA): number of difference constraints touching each pixel."""
    deg = torch.full((H, W), 4.0, dtype=dtype, device=device)
    deg[0, :] -= 1.0
    deg[-1, :] -= 1.0
    deg[:, 0] -= 1.0
    deg[:, -1] -= 1.0
    return deg


# ---------------------------------------------------------------------------
# Geometric multigrid preconditioner.
#
# The 5-point Laplacian's condition number grows like (N/pi)^2, so plain
# Jacobi-PCG needs ~1500 iterations at 1024^2 (the reference's scipy CG
# never converges there either: lib/Normal2Depth.py:107-113 caps maxiter
# and ignores `info`).  A V-cycle drops that to a few dozen.  Everything in
# the cycle is a shift/add or a 2x2 reshape-reduce.
#
# Symmetry (required for CG): smoothing is damped Richardson
# z += alpha*(b - A z) (alpha = 0.2 = the classic 4/5 * 1/diag damping for
# the 2D stencil), which is a symmetric polynomial in A; prolongation P is
# piecewise-constant 2x2 injection and restriction is 0.5 * P^T (2x2 sum),
# which makes the rediscretized unit-spacing coarse Laplacian EXACTLY the
# Galerkin operator P^T A P / 2 in the interior; equal pre/post smoothing
# closes the M = S(I + 0.5 P B P^T)S form, so M is symmetric PSD.
# ---------------------------------------------------------------------------


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """0.5 * (2x2 block sum): the Galerkin-consistent restriction."""
    Hc, Wc = r.shape[-2] // 2, r.shape[-1] // 2
    return 0.5 * r.reshape(*r.shape[:-2], Hc, 2, Wc, 2).sum(dim=(-3, -1))


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant 2x2 injection (adjoint of 2x2 sum)."""
    return e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def make_mg_preconditioner(H: int, W: int, levels: Optional[int] = None,
                           nu: int = 2, alpha: float = 0.2,
                           coarse_iters: int = 32
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return M(r) ~= AtA^{-1} r: one symmetric V(nu,nu)-cycle.

    Non-power-of-two sizes are zero-padded to a multiple of 2^levels inside
    the cycle (M = E^T M_pad E keeps symmetry)."""
    if levels is None:
        levels = 0
        while (min(H, W) >> (levels + 1)) >= 8 and levels < 7:
            levels += 1
    if levels == 0:
        def jacobi(r):
            return r / _degree(H, W, r.dtype, r.device)
        return jacobi
    m = 1 << levels
    Hp = -(-H // m) * m
    Wp = -(-W // m) * m

    def smooth(z, b, n):
        for _ in range(n):
            z = z + alpha * (b - laplacian_AtA(z))
        return z

    def vcycle(b, level):
        if level == levels:
            return smooth(torch.zeros_like(b), b, coarse_iters)
        z = smooth(torch.zeros_like(b), b, nu)
        r = b - laplacian_AtA(z)
        z = z + _prolong(vcycle(_restrict(r), level + 1))
        return smooth(z, b, nu)

    def M(r):
        return vcycle(F.pad(r, (0, Wp - W, 0, Hp - H)), 0)[..., :H, :W]

    return M


def pcg(b: torch.Tensor, M, tol: float = 1e-5, maxiter: int = 200
        ) -> Tuple[torch.Tensor, int, float]:
    """Preconditioned CG on AtA z = b (whole-array inner products, so a
    batched b solves as one joint Krylov space: front+back in one solve).

    Returns (z, iterations_used, relative_residual): the convergence
    diagnostics the reference discards.

    AtA is singular (constant nullspace per (H, W) slice), so the constant
    mode is deflated: b and every preconditioned residual are projected to
    zero mean.  Without this the V-cycle injects an arbitrary constant each
    iteration and the growing offset burns float32 mantissa.

    The exit test (residual, iteration count, divergence guard, stagnation)
    is evaluated every iteration, as ``tpubody``'s ``while_loop`` does, so
    the iterates and the count are the same; it costs one read from the
    device per iteration."""
    def deflate(x):
        return x - x.mean(dim=(-2, -1), keepdim=True)

    def vdot(x, y):
        return (x * y).sum()

    b = deflate(b)
    bnorm2 = vdot(b, b)
    # Floor the tolerance at what the dtype can actually reach: asking f32
    # CG for 1e-8 makes it iterate on rounding noise, where aggressively
    # preconditioned search directions AMPLIFY the noise and z diverges.
    eps = torch.finfo(b.dtype).eps
    atol2 = max(tol * tol, 16.0 * eps * eps) * bnorm2

    z = torch.zeros_like(b)
    r = b
    p = deflate(M(r))
    rho = vdot(r, p)
    rn = bnorm2
    best_z, best_rn = z, rn
    one = torch.ones_like(rho)
    zero = torch.zeros_like(rho)
    k = 0
    # rn is carried: the test at the top of an iteration sees the value the
    # previous iteration computed (tpubody recomputes the same dot product).
    go = bool((rn > atol2) & ~(rn > 100.0 * best_rn)) and k < maxiter
    while go:
        Ap = laplacian_AtA(p)
        pAp = vdot(p, Ap)
        # 0/0 guard at exact stagnation; it ends the loop.
        ok = (pAp > 1e-30) & torch.isfinite(pAp)
        a = torch.where(ok, rho / torch.where(ok, pAp, one), zero)
        z = z + a * p
        r = r - a * Ap
        rn = vdot(r, r)
        better = rn < best_rn
        best_z = torch.where(better, z, best_z)
        best_rn = torch.where(better, rn, best_rn)
        y = deflate(M(r))
        rho_new = vdot(r, y)
        beta = torch.where(rho > 1e-30,
                           rho_new / torch.where(rho > 1e-30, rho, one), zero)
        p = y + beta * p
        rho = rho_new
        k += 1
        # iterating on noise: rn > 100 * best_rn
        flags = torch.stack([ok, (rn > atol2) & ~(rn > 100.0 * best_rn)]
                            ).tolist()
        go = flags[0] and flags[1] and k < maxiter
    relres = float(torch.sqrt(best_rn / torch.clamp(bnorm2, min=1e-30)))
    return best_z, k, relres


def preprocess(normal_img: torch.Tensor, mask: torch.Tensor,
               erode_ksize: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference __init__ semantics (lib/Normal2Depth.py:11-21): erode the
    mask 3x3, map normals from [0,1] to [-1,1], zero them outside the
    (un-eroded) mask."""
    m = (mask > 0)
    eroded = morphology.erode(m, erode_ksize)
    n = normal_img * 2.0 - 1.0
    n = torch.where(m[..., None], n, torch.zeros_like(n))
    return n, eroded


def _rhs(normals: torch.Tensor) -> torch.Tensor:
    """At b: the adjoint applied to the constraint targets (constraints
    exist for j < W-1 / i < H-1 only)."""
    nz = normals[..., 2] + 1e-8
    p = -normals[..., 0] / nz          # target Z(x+1,y) - Z(x,y)
    q = -normals[..., 1] / nz          # target Z(x,y+1) - Z(x,y)
    return _div_x(p[..., :, :-1]) + _div_y(q[..., :-1, :])


def _solve(normals: torch.Tensor, mask: torch.Tensor, maxiter: int,
           tol: float, precond: str) -> Tuple[torch.Tensor, int, float]:
    Atb = _rhs(normals)
    H, W = mask.shape
    if precond == "mg":
        M = make_mg_preconditioner(H, W)
    else:
        inv_deg = 1.0 / _degree(H, W, Atb.dtype, Atb.device)
        M = lambda r: r * inv_deg  # noqa: E731
    z, iters, relres = pcg(Atb, M, tol=tol, maxiter=maxiter)
    z = z - z.amin(dim=(-2, -1), keepdim=True)
    return torch.where(mask, z, torch.zeros_like(z)), iters, relres


def integrate(normals: torch.Tensor, mask: torch.Tensor,
              maxiter: int = 1500, tol: float = 1e-5,
              precond: str = "mg") -> torch.Tensor:
    """Integrate normal map(s) to depth.

    Args:
      normals: (..., H, W, 3) unit-ish normals in [-1, 1], zeroed outside
        the mask (leading axes batch: e.g. (2, H, W, 3) for front+back).
      mask: (H, W) bool; output depth is 0 outside.
      precond: "mg" (multigrid V-cycle) or "jacobi".

    Returns:
      (..., H, W) depth, shifted so min over the batch element is 0 and
      masked (reference lib/Normal2Depth.py:116-122).
    """
    return _solve(normals, mask, maxiter, tol, precond)[0]


def integrate_front_back(
    normal6: torch.Tensor, mask: torch.Tensor,
    maxiter: int = 1500, tol: float = 1e-5, precond: str = "mg",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front+back integration in ONE batched CG (the two solves share the
    operator: vs the reference's two sequential scipy solves,
    lib/Normal2Depth.py:107-113).

    normal6: (H, W, 6) channels [front nx,ny,nz, back nx,ny,nz] in [-1,1].
    """
    stacked = torch.stack([normal6[..., 0:3], normal6[..., 3:6]], dim=0)
    depth = integrate(stacked, mask, maxiter=maxiter, tol=tol,
                      precond=precond)
    return depth[0], depth[1]


def align_back_depth(front_depth: torch.Tensor, back_depth: torch.Tensor
                     ) -> torch.Tensor:
    """Shift the back depth into the front depth's frame using silhouette
    boundary statistics (reference deel_back_depth semantics,
    lib/Normal2Depth.py:544-557): subtract the mean boundary offset between
    the two maps, add a third of the front's boundary-vs-interior offset,
    re-mask.  Boundary extraction uses the morphological ring instead of
    cv2 contour tracing (only the ring's mean is consumed)."""
    mask = front_depth > 0
    ring = morphology.boundary(mask, 3)
    nring = torch.clamp(ring.sum(), min=1)
    zero = torch.zeros_like(front_depth)
    front_bound_mean = torch.where(ring, front_depth, zero).sum() / nring
    back_bound_mean = torch.where(ring, back_depth, zero).sum() / nring
    front_mean = front_depth.mean()
    bound_difference = back_bound_mean - front_bound_mean
    front_difference = front_bound_mean - front_mean
    out = back_depth - bound_difference + front_difference / 3.0
    closed = morphology.close(mask, 3)
    return torch.where(closed, out, zero)


def residual_norm(normals: torch.Tensor, mask: torch.Tensor,
                  depth: torch.Tensor) -> torch.Tensor:
    """Relative residual ||AtA z - At b|| / ||At b|| of a solve, per batch
    element: the convergence diagnostic the reference ignores (scipy cg's
    ``info``, lib/Normal2Depth.py:109-113)."""
    Atb = _rhs(normals)
    r = laplacian_AtA(depth) - Atb
    return (torch.linalg.norm(r.flatten(-2), dim=-1)
            / torch.clamp(torch.linalg.norm(Atb.flatten(-2), dim=-1),
                          min=1e-12))


def normal2depth(normal6_img: torch.Tensor, mask: torch.Tensor,
                 maxiter: int = 1500, tol: float = 1e-5,
                 align_back: bool = False, stats: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full stage: [0,1]-encoded 6-channel normal image + mask -> front/back
    depth.  Mirrors Normal2Depth.__init__ + __call__ (lib/Normal2Depth.py:
    11-29).  A dict passed as ``stats`` receives the solve's ``iterations``
    and ``relative_residual``."""
    m = mask > 0
    n6 = normal6_img * 2.0 - 1.0
    n6 = torch.where(m[..., None], n6, torch.zeros_like(n6))
    eroded = morphology.erode(m, 3)
    stacked = torch.stack([n6[..., 0:3], n6[..., 3:6]], dim=0)
    depth, iters, relres = _solve(stacked, eroded, maxiter, tol, "mg")
    if stats is not None:
        stats.update(iterations=iters, relative_residual=relres)
    front, back = depth[0], depth[1]
    if align_back:
        back = align_back_depth(front, back)
    return front, back
