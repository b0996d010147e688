"""tpubody_torch.mesh.stitch against tpubody.mesh.stitch.

``stitch_mesh`` is fed tpubody's own stitch inputs from its device stages
(tests/torch_recon_common.py: depth maps, photo colours, warped stitch
weights and J_2d of the 1100-vertex humanoid at 128x128).  tpubody takes
its C++ geometry path through the port's build of the same source, so both
run the same host arithmetic: points and faces are held equal (tolerance
0), and the recovered joints too: recover_joints moves a joint to the
centroid of a plane section, and a vertex on a plane flips with the last
bit of the plane's origin, but both packages get the same J_3d, planes and
vertices, so nothing flips (bar 0, measured 0).  ``recover_joints`` alone
is held to tpubody's on perturbed joints with the same bar, and the two
disk scenes of tests/test_mesh.py are stitched by both."""
import numpy as np
import pytest
import torch

from tpubody.mesh import stitch as JSt
from tpubody_torch.mesh import stitch as TSt
from tpubody_torch.utils.profiling import StageTimer

from tests import torch_recon_common as C

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_chain():
    return C.jax_chain_data()


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    C.use_native_geometry(monkeypatch)


@pytest.fixture
def stitched(jax_chain):
    args = C.stitch_inputs(jax_chain)
    return (JSt.stitch_mesh(*args),
            TSt.stitch_mesh(*args, timer=StageTimer(), device="cpu"))


def test_stitch_equals_tpubodys(stitched):
    want, got = stitched
    assert got.points.shape[1] == 30 and got.points.dtype == np.float32
    assert got.points.shape[0] > 2000
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.joints3d, want.joints3d)
    assert got.faces.min() >= 0 and got.faces.max() < got.points.shape[0]


def test_stitch_records_its_substages(jax_chain):
    timer = StageTimer()
    TSt.stitch_mesh(*C.stitch_inputs(jax_chain), timer=timer, device="cpu")
    assert [r["stage"] for r in timer.records] == [
        "stitch/close_mask", "stitch/depth_to_mesh", "stitch/rings",
        "stitch/bspline_band", "stitch/assemble", "stitch/recover_joints"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recover_joints_equals_tpubodys(stitched, seed):
    """The same J_3d into both: the arm chain's joints moved to section
    centroids."""
    _, got = stitched
    rng = np.random.default_rng(seed)
    J = got.joints3d + rng.normal(scale=0.5, size=(24, 3))
    verts = got.points[:, :3]
    out = TSt.recover_joints(verts, got.faces, J)
    np.testing.assert_array_equal(out, JSt.recover_joints(verts, got.faces,
                                                          J))
    moved = np.abs(out - J).max(axis=1) > 0
    assert moved[[18, 20]].all() and not moved[:16].any()


def disk_scene(H, W, r, base, far):
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = (xx - W // 2) ** 2 + (yy - H // 2) ** 2
    mask = d2 < r * r
    front = np.where(mask, base + np.sqrt(np.maximum(r * r - d2, 0)) * 0.3,
                     0.0)
    back = np.where(mask, far - (front - base), 0.0)
    J = np.tile(np.array([[W // 2, H // 2]]), (24, 1))
    J[16] = [W // 2 - 6, H // 2 - 4]; J[17] = [W // 2 + 6, H // 2 - 4]
    J[18] = [W // 2 - 10, H // 2]; J[19] = [W // 2 + 10, H // 2]
    J[20] = [W // 2 - 12, H // 2 + 3]; J[21] = [W // 2 + 12, H // 2 + 3]
    J[22] = [W // 2 - 13, H // 2 + 4]; J[23] = [W // 2 + 13, H // 2 + 4]
    J[0] = [W // 2, H // 2 + 8]; J[3] = [W // 2, H // 2 - 8]
    J[1] = [W // 2 - 4, H // 2 + 8]; J[2] = [W // 2 + 4, H // 2 + 8]
    return front, back, J


@pytest.mark.parametrize("scene", [(48, 48, 14, 10.0, 22.0),
                                   (40, 40, 12, 5.0, 14.0)])
def test_disk_stitch_equals_tpubodys(scene):
    H, W = scene[:2]
    front, back, J = disk_scene(*scene)
    cf = np.tile(np.array([255.0, 0, 0]), (H, W, 1))
    cb = np.tile(np.array([0.0, 0, 255]), (H, W, 1))
    weights = np.zeros((H, W, 24))
    weights[..., 0] = 1.0
    got = TSt.stitch_mesh(front, cf, back, cb, weights, J, device="cpu")
    want = JSt.stitch_mesh(front, cf, back, cb, weights, J)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the band blends the colours from front to back
    blended = got.points[(got.points[:, 3] > 0) & (got.points[:, 5] > 0)]
    assert blended.shape[0] > 0


def test_stitch_defaults_to_the_card(jax_chain):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TSt.stitch_mesh(*C.stitch_inputs(jax_chain))
