"""tpubody_torch.mesh.grid_mesh against tpubody.mesh.grid_mesh on seeded
depth sheets at 64x128: the grid triangulation (front, and back rotated
about y), the boundary ring, the inner ring, the adjacency and the back
rotation angle.  tpubody takes its C++ path here, through the port's build
of the same source (tests/torch_recon_common.py says why), and both sides
then run the same arithmetic: every output is held equal (tolerance 0).
tests/test_torch_geometry_native.py holds the C++ routines to the Python
plain versions."""
import numpy as np
import pytest

from tpubody.mesh import grid_mesh as JG
from tpubody_torch.mesh import grid_mesh as TG

from tests.test_torch_geometry_native import depth_sheet
from tests.torch_recon_common import use_native_geometry


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    use_native_geometry(monkeypatch)


@pytest.mark.parametrize("rotate_y", [None, 0.3, -1.1])
@pytest.mark.parametrize("seed", [0, 1])
def test_depth_to_mesh_equals_tpubodys(seed, rotate_y):
    m, depth, color, weights = depth_sheet(seed)
    for is_back in (False, True):
        got = TG.depth_to_mesh(depth, color, weights, m, is_back=is_back,
                               rotate_y=rotate_y)
        want = JG.depth_to_mesh(depth, color, weights, m, is_back=is_back,
                                rotate_y=rotate_y)
        assert got.points.dtype == np.float32
        np.testing.assert_array_equal(got.points, want.points)
        np.testing.assert_array_equal(got.faces, want.faces)
        np.testing.assert_array_equal(got.verts, want.verts)
        np.testing.assert_array_equal(got.colors, want.colors)


def test_back_sheet_winding_is_flipped():
    m, depth, color, weights = depth_sheet(3)

    def z_orient(mesh):
        v, t = mesh.points[:, :3], mesh.faces
        return np.cross(v[t[:, 1]] - v[t[:, 0]],
                        v[t[:, 2]] - v[t[:, 0]])[:, 2].sum()

    f = TG.depth_to_mesh(depth, color, weights, m)
    b = TG.depth_to_mesh(depth, color, weights, m, is_back=True)
    assert z_orient(f) * z_orient(b) < 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rings_and_adjacency_equal_tpubodys(seed):
    m, depth, color, weights = depth_sheet(seed)
    mesh = TG.depth_to_mesh(depth, color, weights, m)
    ring = TG.boundary_ring(mesh.faces)
    np.testing.assert_array_equal(ring, JG.boundary_ring(mesh.faces))
    n = mesh.points.shape[0]
    inner = TG.inner_ring(mesh.faces, ring, n)
    np.testing.assert_array_equal(inner, JG.inner_ring(mesh.faces, ring, n))
    for a, b in zip(TG.vertex_adjacency(mesh.faces, n),
                    JG.vertex_adjacency(mesh.faces, n)):
        np.testing.assert_array_equal(a, b)
    # consecutive ring vertices are grid neighbours
    v = mesh.points[:, :3]
    d = np.linalg.norm(np.diff(v[np.concatenate([ring, ring[:1]]), :2],
                               axis=0), axis=1)
    assert d.max() < 1.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_back_rotation_angle_equals_tpubodys(seed):
    rng = np.random.default_rng(seed)
    front = rng.uniform(1.0, 3.0, (64, 128))
    back = front + rng.normal(scale=0.3, size=front.shape)
    J = np.stack([rng.integers(0, 128, 24), rng.integers(0, 64, 24)], 1)
    got = TG.back_rotation_angle(front, back, J)
    assert got == JG.back_rotation_angle(front, back, J)
    assert TG.back_rotation_angle(front, front, J) == 0.0
    R = TG.rotation_about_y(got)
    np.testing.assert_array_equal(R, JG.rotation_about_y(got))
