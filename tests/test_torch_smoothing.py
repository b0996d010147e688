"""tpubody_torch.mesh.smoothing against tpubody.mesh.smoothing on seeded
meshes: a noisy grid sheet (Humphrey and Laplacian filters over the CSR
adjacency) and a noisy cyclic band (the stitch band's shape).  Both run
the same float64 numpy arithmetic on the host, so every output is held
equal bit for bit (tolerance 0)."""
import numpy as np
import pytest

from tpubody.mesh import grid_mesh as JG
from tpubody.mesh import smoothing as JSm
from tpubody_torch.mesh import grid_mesh as TG
from tpubody_torch.mesh import smoothing as TSm

from tests.test_torch_slicing import sheet


@pytest.mark.parametrize("seed", [0, 1])
def test_vertex_adjacency_equals_tpubodys(seed):
    verts, faces = sheet(seed=seed)
    for a, b in zip(TG.vertex_adjacency(faces, verts.shape[0]),
                    JG.vertex_adjacency(faces, verts.shape[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("alpha,beta,iters", [(0.1, 0.5, 10), (0.3, 0.7, 3)])
def test_humphrey_equals_tpubodys(alpha, beta, iters):
    verts, faces = sheet()
    got = TSm.humphrey(verts, faces, alpha, beta, iters)
    np.testing.assert_array_equal(
        got, JSm.humphrey(verts, faces, alpha, beta, iters))
    # it smooths: the noise across the sheet's rows goes down
    rough = np.abs(np.diff(verts[:, 2].reshape(20, 20), 2, axis=0)).mean()
    assert np.abs(np.diff(got[:, 2].reshape(20, 20), 2, axis=0)).mean() \
        < rough


@pytest.mark.parametrize("lamb,iters", [(0.5, 10), (0.2, 4)])
def test_laplacian_equals_tpubodys(lamb, iters):
    verts, faces = sheet(seed=2)
    np.testing.assert_array_equal(
        TSm.laplacian(verts, faces, lamb, iters),
        JSm.laplacian(verts, faces, lamb, iters))


@pytest.mark.parametrize("shape", [(9, 40, 3), (3, 7, 3)])
def test_smooth_band_grid_equals_tpubodys(shape):
    rng = np.random.default_rng(3)
    band = rng.normal(size=shape)
    got = TSm.smooth_band_grid(band)
    np.testing.assert_array_equal(got, JSm.smooth_band_grid(band))
    assert got.shape == shape and np.isfinite(got).all()
