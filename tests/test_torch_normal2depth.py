"""tpubody_torch.solve.normal2depth against tpubody.solve.normal2depth on
the CPU, at 64x64 (three multigrid levels) and an odd 50x70 that the
V-cycle pads.

Tolerances: the Laplacian, the V-cycle and one PCG are the same float32
expressions with sums in another order: 1e-5 relative to the largest
value for the operator and the cycle.  The solve is an iteration on those,
so depth is held to 1e-3 of the depth range, the iteration count to +-2
and the achieved residual to within 10% of tpubody's."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.solve import normal2depth as JN
from tpubody_torch.solve import normal2depth as TN

torch.set_num_threads(1)
OP_RTOL = 1e-5


def t(x):
    return torch.as_tensor(np.array(x))


def sphere_normals(H, W, r=None):
    """[0,1]-encoded front/back normals of a sphere and its mask."""
    r = r or 0.4 * min(H, W)
    yy, xx = np.mgrid[0:H, 0:W]
    x, y = (xx - W / 2 + 0.5) / r, (yy - H / 2 + 0.5) / r
    rr = x * x + y * y
    mask = rr < 0.9
    z = np.sqrt(np.clip(1 - rr, 1e-3, None))
    front = np.stack([x, y, z], -1)
    back = np.stack([-x, y, z], -1)
    n6 = np.concatenate([front, back], -1)
    img = ((n6 + 1) / 2).astype(np.float32)
    img[~mask] = 1.0
    return img, mask


def close(got, want, rtol=OP_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(64, 64), (2, 50, 70)])
def test_laplacian_and_degree(shape):
    z = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    close(TN.laplacian_AtA(t(z)), JN.laplacian_AtA(jnp.asarray(z)))
    H, W = shape[-2:]
    np.testing.assert_array_equal(
        TN._degree(H, W, torch.float32).numpy(),
        np.asarray(JN._degree(H, W, jnp.float32)))
    # the degree is the operator's diagonal
    e = np.zeros((H, W), np.float32)
    e[0, 0] = e[5, 7] = e[-1, 3] = 1.0
    d = TN.laplacian_AtA(t(e)).numpy()
    deg = TN._degree(H, W, torch.float32).numpy()
    assert d[0, 0] == deg[0, 0] == 2 and d[5, 7] == 4 and d[-1, 3] == 3


@pytest.mark.parametrize("H,W,levels", [(64, 64, None), (50, 70, None),
                                        (32, 32, 0), (40, 40, 2)])
def test_vcycle(H, W, levels):
    r = np.random.default_rng(1).normal(size=(2, H, W)).astype(np.float32)
    r -= r.mean(axis=(-2, -1), keepdims=True)
    JM = JN.make_mg_preconditioner(H, W, levels=levels)
    TM = TN.make_mg_preconditioner(H, W, levels=levels)
    close(TM(t(r)), JM(jnp.asarray(r)))


def test_pcg_counts_and_residual():
    img, mask = sphere_normals(64, 64)
    n = np.where(mask[..., None], img * 2 - 1, 0).astype(np.float32)
    stacked = np.stack([n[..., :3], n[..., 3:]])
    b = np.asarray(JN._div_x(jnp.asarray(
        -stacked[..., 0] / (stacked[..., 2] + 1e-8))[..., :, :-1], 64)
        + JN._div_y(jnp.asarray(
            -stacked[..., 1] / (stacked[..., 2] + 1e-8))[..., :-1, :], 64))
    close(TN._rhs(t(stacked)), b)
    for precond in ("mg", "jacobi"):
        if precond == "mg":
            JM, TM = (N.make_mg_preconditioner(64, 64) for N in (JN, TN))
        else:
            JM = lambda r: r / JN._degree(64, 64, r.dtype)  # noqa: E731
            TM = lambda r: r / TN._degree(64, 64, r.dtype)  # noqa: E731
        jz, jk, jres = JN.pcg(jnp.asarray(b), JM, tol=1e-5, maxiter=300)
        z, k, res = TN.pcg(t(b), TM, tol=1e-5, maxiter=300)
        assert isinstance(k, int) and abs(k - int(jk)) <= 2, (k, int(jk))
        assert res <= float(jres) * 1.1 + 1e-7
        zr = np.ptp(np.asarray(jz))
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-3 * zr)
    # maxiter stops it
    _, k3, _ = TN.pcg(t(b), TM, tol=1e-9, maxiter=3)
    assert k3 == 3
    # a zero right-hand side never enters the loop
    z0, k0, _ = TN.pcg(torch.zeros(2, 64, 64), TM)
    assert k0 == 0 and not z0.any()


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_normal2depth_on_a_sphere(H, W):
    img, mask = sphere_normals(H, W)
    jf, jb = JN.normal2depth(jnp.asarray(img), jnp.asarray(mask))
    stats = {}
    f, b = TN.normal2depth(t(img), t(mask), stats=stats)
    for got, want in ((f, jf), (b, jb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-3 * np.ptp(want))
    eroded = np.asarray(JN.morphology.erode(jnp.asarray(mask), 3))
    assert (f.numpy()[~eroded] == 0).all() and f.numpy().max() > 5
    # residual no worse than tpubody's by more than 10%
    n6 = np.where(mask[..., None], img * 2 - 1, 0).astype(np.float32)
    stacked = np.stack([n6[..., :3], n6[..., 3:]])
    raw = TN._solve(t(stacked), torch.ones(H, W, dtype=torch.bool), 1500,
                    1e-5, "mg")
    jraw = JN.integrate(jnp.asarray(stacked), jnp.ones((H, W), bool))
    res = TN.residual_norm(t(stacked), t(mask), raw[0]).numpy()
    jres = np.asarray(JN.residual_norm(jnp.asarray(stacked),
                                       jnp.asarray(mask), jraw))
    close(TN.residual_norm(t(stacked), t(mask), t(np.asarray(jraw))), jres,
          rtol=1e-3)
    assert (res <= jres * 1.1 + 1e-6).all(), (res, jres)
    assert stats["iterations"] == raw[1] > 0
    assert stats["relative_residual"] < 1e-3


def test_integrate_front_back_jacobi_and_preprocess():
    img, mask = sphere_normals(32, 32)
    n, eroded = TN.preprocess(t(img[..., :3]), t(mask))
    jn_, jeroded = JN.preprocess(jnp.asarray(img[..., :3]), jnp.asarray(mask))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn_))
    np.testing.assert_array_equal(eroded.numpy(), np.asarray(jeroded))
    n6 = np.where(mask[..., None], img * 2 - 1, 0).astype(np.float32)
    f, b = TN.integrate_front_back(t(n6), eroded, precond="jacobi")
    jf, jb = JN.integrate_front_back(jnp.asarray(n6), jeroded,
                                     precond="jacobi")
    for got, want in ((f, jf), (b, jb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-3 * np.ptp(want))


def test_align_back_depth():
    img, mask = sphere_normals(64, 64)
    f, b = TN.normal2depth(t(img), t(mask))
    want = np.asarray(JN.align_back_depth(jnp.asarray(f.numpy()),
                                          jnp.asarray(b.numpy())))
    got = TN.align_back_depth(f, b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    fa, ba = TN.normal2depth(t(img), t(mask), align_back=True)
    np.testing.assert_array_equal(ba.numpy(), got)
