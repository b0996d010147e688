"""tpubody_torch.mesh.slicing against tpubody.mesh.slicing on seeded
meshes: an open tube with a 30-column attribute block (tests/test_hands.py's
input) and a bumpy grid sheet, cut by seeded planes.  Both run the same
numpy arithmetic on the host, so every output is held equal bit for bit
(tolerance 0), in float32 and float64."""
import numpy as np
import pytest

from tpubody.mesh import slicing as JSl
from tpubody_torch.mesh import slicing as TSl


def tube(radius=0.3, n_ax=24, n_circ=16, seed=0):
    """Open cylinder along x with attribute block [xyz, rgb, w24]."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2.0, 2.0, n_ax)
    th = np.linspace(0, 2 * np.pi, n_circ, endpoint=False)
    verts = np.array([[x, radius * np.cos(t), radius * np.sin(t)]
                      for x in xs for t in th])
    faces = []
    for i in range(n_ax - 1):
        for j in range(n_circ):
            a, b = i * n_circ + j, i * n_circ + (j + 1) % n_circ
            c, d = a + n_circ, b + n_circ
            faces += [[a, b, c], [b, d, c]]
    attrs = np.zeros((verts.shape[0], 30))
    attrs[:, :3] = verts
    attrs[:, 3:6] = rng.uniform(0, 255, (verts.shape[0], 3))
    attrs[:, 6:] = rng.dirichlet(np.ones(24), size=verts.shape[0])
    return attrs, np.asarray(faces, np.int64)


def sheet(n=20, seed=1):
    """A bumpy n x n grid sheet in the z = f(x, y) form."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float64)
    z = 0.3 * np.sin(x / 3.0) + 0.05 * rng.normal(size=x.shape)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    return verts, faces.astype(np.int64)


PLANES = [
    ([0.5, 0.0, 0.0], [1.0, 0.0, 0.0]),
    ([-1.0, 0.05, 0.0], [1.0, 0.3, -0.2]),
    ([0.77, 0.0, 0.1], [-1.0, 0.1, 0.4]),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("plane", range(len(PLANES)))
def test_sections_equal_tpubodys(dtype, plane):
    pts, faces = tube()
    v = pts[:, :3].astype(dtype)
    origin, normal = PLANES[plane]
    np.testing.assert_array_equal(TSl.signed_distance(v, origin, normal),
                                  JSl.signed_distance(v, origin, normal))
    for a, b in zip(TSl.section_segments(v, faces, origin, normal),
                    JSl.section_segments(v, faces, origin, normal)):
        np.testing.assert_array_equal(a, b)
    got = TSl.section_centroid(v, faces, origin, normal)
    np.testing.assert_array_equal(
        got, JSl.section_centroid(v, faces, origin, normal))
    ring = TSl.section_ring(v, faces, origin, normal, near=origin)
    np.testing.assert_array_equal(
        ring, JSl.section_ring(v, faces, origin, normal, near=origin))
    assert ring.shape[0] >= 8
    assert TSl.ring_length(ring) == JSl.ring_length(ring)


def test_section_ring_on_the_tube_is_its_circle():
    pts, faces = tube()
    ring = TSl.section_ring(pts[:, :3], faces, [0.5, 0, 0], [1, 0, 0])
    np.testing.assert_allclose(ring[:, 0], 0.5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(ring[:, 1:], axis=1), 0.3,
                               atol=1e-2)


def test_section_of_a_vertex_on_the_plane_equals_tpubodys():
    """Planes through grid vertices: the on-plane branch."""
    verts, faces = sheet()
    for origin, normal in (([5.0, 0, 0], [1, 0, 0]),
                           ([0, 7.0, 0], [0, 1, 0])):
        for a, b in zip(TSl.section_segments(verts, faces, origin, normal),
                        JSl.section_segments(verts, faces, origin, normal)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            TSl.section_centroid(verts, faces, origin, normal),
            JSl.section_centroid(verts, faces, origin, normal))


@pytest.mark.parametrize("plane", range(len(PLANES)))
def test_cut_faces_plane_equals_tpubodys(plane):
    pts, faces = tube()
    origin, normal = PLANES[plane]
    got = TSl.cut_faces_plane(pts, faces, origin, normal)
    want = JSl.cut_faces_plane(pts, faces, origin, normal)
    assert got.tracked is None and want.tracked is None
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    # a second cut that tracks the first one's boundary
    o2, n2 = [1.0, 0, 0], [-1.0, 0, 0]
    got2 = TSl.cut_faces_plane(got.points, got.faces, o2, n2,
                               track=got.boundary)
    want2 = JSl.cut_faces_plane(want.points, want.faces, o2, n2,
                                track=want.boundary)
    for a, b in zip(got2, want2):
        np.testing.assert_array_equal(a, b)
    assert got2.tracked.shape[0] > 4
    # attribute rows of the new points are interpolated along the cut
    assert np.isfinite(got2.points).all()
    np.testing.assert_allclose(got2.points[:, 6:].sum(axis=1), 1.0,
                               atol=1e-12)


def test_halfspace_and_restrict_equal_tpubodys():
    verts, faces = sheet()
    origin, normal = [9.5, 9.5, 0.0], [0.6, 0.8, 0.0]
    m = TSl.halfspace_vertex_mask(verts, origin, normal)
    np.testing.assert_array_equal(
        m, JSl.halfspace_vertex_mask(verts, origin, normal))
    kept = TSl.restrict_faces(faces, m)
    np.testing.assert_array_equal(kept, JSl.restrict_faces(faces, m))
    assert 0 < kept.shape[0] < faces.shape[0]
    assert m[kept].all()
