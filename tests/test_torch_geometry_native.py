"""The C++ host-geometry helper (tpubody_torch/csrc/geometry.cpp through
tpubody_torch.geometry) against the port's Python plain versions and
against tpubody's outputs, for all five functions, on seeded masks and
grid meshes at 64x128.  Integer outputs and float32 gathers are held equal
(tolerance 0); the once-only edges, which the numpy version lists in face
order and the C++ one in code order, are held equal as sets.

tpubody's own outputs are taken on both of its paths: its Python path
(``use_python_geometry``) and its C++ path, served by the port's build of
the same source (``use_native_geometry``), so that no test depends on
whether tpubody's unlocked build won its race on this worker."""
import numpy as np
import pytest

from tpubody.image import boundary_match as JBm
from tpubody.image import contours as JCt
from tpubody.mesh import grid_mesh as JG
from tpubody_torch import geometry, native
from tpubody_torch.image import boundary_match as TBm
from tpubody_torch.image import contours as TCt
from tpubody_torch.mesh import grid_mesh as TG

from tests.torch_recon_common import use_native_geometry, use_python_geometry

H, W = 64, 128


def blob_mask(seed):
    """A seeded union of ellipses (several regions; the first in scan
    order is traced)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    m = np.zeros((H, W), bool)
    for _ in range(4):
        cy, cx = rng.uniform(8, H - 8), rng.uniform(8, W - 8)
        ry, rx = rng.uniform(3, 20), rng.uniform(3, 40)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    m[0, :] = False                      # pixel 0 stays background
    return m


def snake_mask():
    """A 1-pixel snake: its perimeter is far longer than 8 (H + W)."""
    m = np.zeros((H, W), np.uint8)
    for i in range(0, H, 2):
        m[i, 1:-1] = 1
        if (i // 2) % 2 == 0 and i + 1 < H:
            m[i + 1, -2] = 1
        elif i + 1 < H:
            m[i + 1, 1] = 1
    return m


MASKS = {f"blob{s}": (lambda s=s: blob_mask(s)) for s in range(4)}
MASKS["snake"] = snake_mask
MASKS["speck"] = lambda: np.pad(np.ones((1, 2), bool), ((5, H - 6),
                                                        (9, W - 11)))
MASKS["empty"] = lambda: np.zeros((H, W), bool)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_trace_boundary(name, monkeypatch):
    mask = MASKS[name]()
    got = TCt.trace_boundary(mask)
    assert got.dtype == np.int64 and got.shape[1] == 2
    np.testing.assert_array_equal(got, TCt.trace_boundary_reference(mask))
    use_python_geometry(monkeypatch)
    np.testing.assert_array_equal(got, JCt.trace_boundary(mask))
    if name == "snake":
        assert got.shape[0] > 8 * (H + W)


def depth_sheet(seed):
    """Seeded depth, colour and weights over a blob mask."""
    rng = np.random.default_rng(seed)
    m = blob_mask(seed)
    depth = np.where(m, 5.0 + rng.random((H, W)), 0.0).astype(np.float32)
    color = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    weights = rng.dirichlet(np.ones(24), size=(H, W)).astype(np.float32)
    return m, depth, color, weights


@pytest.mark.parametrize("is_back", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_mesh_build(seed, is_back, monkeypatch):
    m, depth, color, weights = depth_sheet(seed)
    points, faces = geometry.grid_mesh_build(m, depth, color, weights,
                                             is_back)
    assert points.dtype == np.float32 and faces.dtype == np.int64
    p_ref, f_ref = TG.grid_mesh_build_reference(m, depth, color, weights,
                                                is_back)
    np.testing.assert_array_equal(points, p_ref)
    np.testing.assert_array_equal(faces, f_ref)
    use_python_geometry(monkeypatch)
    want = JG.depth_to_mesh(depth, color, weights, m, is_back=is_back)
    np.testing.assert_array_equal(points, want.points)
    np.testing.assert_array_equal(faces, want.faces)


def edge_set(e):
    return {(min(a, b), max(a, b)) for a, b in np.asarray(e).tolist()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_boundary_edges_and_ring_walk(seed, monkeypatch):
    m, depth, color, weights = depth_sheet(seed)
    _, faces = geometry.grid_mesh_build(m, depth, color, weights, False)
    be = geometry.boundary_edges_from_faces(faces)
    assert (be[:, 0] < be[:, 1]).all()
    ref = TG.boundary_edges_reference(faces)
    assert be.shape == ref.shape and edge_set(be) == edge_set(ref)
    ring = geometry.boundary_ring_walk(be)
    np.testing.assert_array_equal(ring, TG.boundary_ring_walk_reference(be))
    assert len(set(ring.tolist())) == ring.shape[0] > 10
    # tpubody on its Python path: the same edge set, walked from another
    # start (face order), over the same vertices
    use_python_geometry(monkeypatch)
    assert edge_set(JG.boundary_edges(faces)) == edge_set(be)
    assert set(JG.boundary_ring(faces).tolist()) == set(ring.tolist())
    # tpubody on its C++ path: equal
    monkeypatch.undo()
    use_native_geometry(monkeypatch)
    np.testing.assert_array_equal(JG.boundary_edges(faces), be)
    np.testing.assert_array_equal(JG.boundary_ring(faces), ring)


def test_boundary_edges_of_a_triangle_soup():
    """Every edge once-only: the output fills the whole capacity."""
    faces = np.arange(30, dtype=np.int64).reshape(10, 3)
    be = geometry.boundary_edges_from_faces(faces)
    assert be.shape == (30, 2)
    assert edge_set(be) == edge_set(TG.boundary_edges_reference(faces))
    assert geometry.boundary_edges_from_faces(
        np.zeros((0, 3), np.int64)).shape == (0, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_backtrack(seed):
    rng = np.random.default_rng(seed)
    m, n = 40, 130
    args = rng.integers(0, n, (m - 1, n))
    j = int(rng.integers(0, n))
    got = geometry.dp_backtrack(args, j)
    np.testing.assert_array_equal(
        got, TBm.dp_backtrack_reference(args, j))
    assert got.shape == (m,) and got[-1] == j


@pytest.mark.parametrize("seed", [0, 1])
def test_match_boundaries_equals_tpubodys_python_path(seed, monkeypatch):
    """The whole boundary match on two traced contours: the port's (C++
    backtrack) against tpubody's on its Python backtrack."""
    a = TCt.trace_boundary(blob_mask(seed))
    rng = np.random.default_rng(seed)
    b = a[np.sort(rng.choice(a.shape[0], a.shape[0] * 3 // 4,
                             replace=False))]
    got = TBm.match_boundaries(a, b, device="cpu")
    use_python_geometry(monkeypatch)
    np.testing.assert_array_equal(got, np.asarray(JBm.match_boundaries(a, b)))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    broken = tmp_path / "geometry.cpp"
    broken.write_text('extern "C" int64_t trace_boundary( {\n')
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(geometry, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        geometry.build()
    assert "error" in str(e.value)
    assert not (tmp_path / "build" / geometry.LIB_NAME).exists()
