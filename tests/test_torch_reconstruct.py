"""The device half of tpubody_torch.pipelines.reconstruct (SMPLH forward,
joint projection, body maps, silhouette warp, normal-to-depth) against the
same stages of tpubody, on the CPU at 128x128 with the 1100-vertex
humanoid in the demo pose.  The photo mask is the body rendered at other
betas than the fit's, so the warp moves pixels.

Each stage of the port is fed tpubody's input to that stage, because one
flipped edge pixel changes the traced contour and all that follows:
  * SMPLH forward: vertices within 1e-5 (m), projected joints equal;
  * body maps: the bars of tests/test_torch_bodymaps.py;
  * warp: contours and match equal; values within 1e-4 (the box filters
    sum in another order; medians select);
  * normal2depth: within 1e-3 of the depth range, iteration count within 2.
The free-running chain (the helper of reconstruct.py, cache off) is held
to a mean depth difference under 1% of the depth range, and, where the
two rendered silhouettes came out equal, to the per-stage bars: 1e-3 of
the depth range, and 1e-3 on the stitch weights (1e-4 of the warp plus
the float16 the device-resident branch carries them in, 2^-11 = 4.9e-4).
The cached branch writes tpubody's side-car files and is hit on a second
run.

``reconstruct`` runs to its end in both cache modes, with and without the
hand graft, and writes tpubody's artefact names.  Free-running against
``tpubody.reconstruct`` on the same inputs (tpubody's host geometry on its
C++ path, tests/torch_recon_common.py), the silhouettes come out equal
here, so the per-stage bars apply to what follows: stitched vertex and
face counts and faces equal, colours equal, positions and recovered
joints within 1e-3 of the depth range (measured 7.0e-5 and 1.3e-5 of a
7.6 range), stitch weights within 1e-3 (the float16 crossing, 2^-11), the
avatar's v_template and joints within 1e-4 (BASELINE.json's vertex bar;
measured 2.2e-5 and 3.9e-7).  At 128^2 the humanoid's wrists are too thin
for a section ring: both packages take the hand graft's degrade branch
alike (the same warning, the avatar unchanged)."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.image import warp as JW
from tpubody.pipelines import reconstruct as JR
from tpubody.solve import normal2depth as JN
from tpubody.utils import cache as jcache
from tpubody_torch.image import warp as TW
from tpubody_torch.mesh import gltf as TGl
from tpubody_torch.mesh import meshio as TMio
from tpubody_torch.mesh import rigging as TRig
from tpubody_torch.models import humanoid as TH
from tpubody_torch.pipelines import reconstruct as TRc
from tpubody_torch.render import bodymaps as TB
from tpubody_torch.solve import normal2depth as TN
from tpubody_torch.utils.cache import StageCache, digest
from tpubody_torch.utils.profiling import StageTimer

from tests import torch_recon_common
from tests.test_torch_bodymaps import SLIVER_ATOL, SLIVER_SHARE, VALUE_ATOL

torch.set_num_threads(1)

SIZE = torch_recon_common.SIZE
N_VERTS = torch_recon_common.N_VERTS
VERT_ATOL = 1e-5
WARP_ATOL = 1e-4
DEPTH_REL = 1e-3
WEIGHT_ATOL = 1e-3
CHAIN_MEAN_REL = 1e-2
AVATAR_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_chain():
    """tpubody's stages 1-5 (reconstruct.py:105-210) and their inputs."""
    return torch_recon_common.jax_chain_data()


@pytest.fixture(scope="module")
def models():
    return (TH.humanoid(52, N_VERTS, device="cpu"),
            TH.humanoid(24, N_VERTS, device="cpu"))


def run_helper(jc, models, run_dir, cache):
    timer, keep = StageTimer(), {}
    out = TRc._device_stages(jc["mask_u8"], TRc.FitResult(*jc["fit"]),
                             models[0], models[1],
                             StageCache(str(run_dir), enabled=cache), timer,
                             None, keep=keep)
    return out, keep, timer


@pytest.fixture(scope="module")
def port_chain(jax_chain, models, tmp_path_factory):
    """The port's helper, free-running, device-resident branch."""
    return run_helper(jax_chain, models, tmp_path_factory.mktemp("off"),
                      False)


def test_photo_mask_differs_from_the_rendered_silhouette(jax_chain):
    sil = np.asarray(JW.silhouette_from_value(jnp.asarray(
        jax_chain["value"])))
    assert (sil != jax_chain["mask"]).sum() > 100
    assert jax_chain["mask"].sum() > 1000


def test_stage_smplh_forward_and_joints(jax_chain, models, port_chain):
    from tpubody_torch.models import smpl as TS

    fit = jax_chain["fit"]
    pose = torch.as_tensor(fit.pose.reshape(-1, 3), dtype=torch.float32)
    verts = TS.forward(models[0], pose,
                       torch.as_tensor(fit.shape, dtype=torch.float32)).verts
    np.testing.assert_allclose(verts.numpy(), jax_chain["verts"],
                               atol=VERT_ATOL)
    (J_2d, _, _, _), _, _ = port_chain
    assert J_2d.shape == (24, 2) and J_2d.dtype.kind == "i"
    np.testing.assert_array_equal(J_2d, jax_chain["J_2d"])


def assert_value_maps_agree(got, want):
    np.testing.assert_array_equal((got == 1.0).all(-1), (want == 1.0).all(-1))
    np.testing.assert_allclose(got, want, atol=SLIVER_ATOL)
    assert (np.abs(got - want) > VALUE_ATOL).mean() <= SLIVER_SHARE


def test_stage_render_on_tpubodys_vertices(jax_chain):
    jc = jax_chain
    fit = jc["fit"]
    got = TB.render_body_maps(jc["verts"], jc["faces"], jc["weights"],
                              fit.camera_translation, fit.camera_center,
                              SIZE, SIZE, focal=fit.camera_fx, device="cpu")
    assert_value_maps_agree(got.value.numpy(), jc["value"])


def test_stage_warp_on_tpubodys_value_map(jax_chain):
    jc = jax_chain
    got = TW.warp_stage(jc["mask_u8"], jc["value"], device="cpu")
    want = jc["warp"]
    np.testing.assert_array_equal(got.rgb_bound, np.asarray(want.rgb_bound))
    np.testing.assert_array_equal(got.smpl_bound, np.asarray(want.smpl_bound))
    np.testing.assert_array_equal(got.match, np.asarray(want.match))
    np.testing.assert_allclose(got.value.numpy(), jc["warp_value"],
                               atol=WARP_ATOL)
    # the warped map fills the photo mask and is zero outside it
    v = got.value.numpy()
    assert (np.abs(v[jc["mask"]]).sum(-1) > 0).all()
    assert (v[~jc["mask"]] == 0).all()


def test_stage_normal2depth_on_tpubodys_warped_map(jax_chain):
    jc = jax_chain
    stats = {}
    front, back = TN.normal2depth(torch.as_tensor(jc["warp_value"][..., :6]),
                                  torch.as_tensor(jc["mask"]), stats=stats)
    rng = float(jc["front"].max() - jc["front"].min())
    assert rng > 1.0
    np.testing.assert_allclose(front.numpy(), jc["front"],
                               atol=DEPTH_REL * rng)
    np.testing.assert_allclose(back.numpy(), jc["back"], atol=DEPTH_REL * rng)
    # tpubody's own count: its solver on the same right-hand side
    n6 = torch.as_tensor(jc["warp_value"][..., :6]) * 2.0 - 1.0
    n6 = n6 * torch.as_tensor(jc["mask"])[..., None]
    Atb = TN._rhs(torch.stack([n6[..., 0:3], n6[..., 3:6]])).numpy()
    _, jiters, jres = JN.pcg(jnp.asarray(Atb),
                             JN.make_mg_preconditioner(SIZE, SIZE),
                             tol=1e-5, maxiter=1500)
    assert abs(stats["iterations"] - int(jiters)) <= 2
    assert stats["relative_residual"] < 1e-3
    assert stats["relative_residual"] <= 1.1 * float(jres) + 1e-7


def test_free_running_chain(jax_chain, port_chain):
    jc = jax_chain
    (_, weights, front, back), keep, timer = port_chain
    assert front.shape == back.shape == (SIZE, SIZE)
    assert weights.shape == (SIZE, SIZE, 24) and weights.dtype == np.float32
    assert np.isfinite(front).all() and np.isfinite(back).all()
    assert (front[~jc["mask"]] == 0).all() and (back[~jc["mask"]] == 0).all()
    rng = float(jc["front"].max() - jc["front"].min())
    for got, want in ((front, jc["front"]), (back, jc["back"])):
        assert np.abs(got - want).mean() < CHAIN_MEAN_REL * rng
    value = keep["value"].numpy()
    same_silhouette = np.array_equal((value == 1.0).all(-1),
                                     (jc["value"] == 1.0).all(-1))
    assert same_silhouette      # on this fixture; else only the mean holds
    np.testing.assert_allclose(front, jc["front"], atol=DEPTH_REL * rng)
    np.testing.assert_allclose(back, jc["back"], atol=DEPTH_REL * rng)
    np.testing.assert_allclose(weights, jc["warp_value"][..., 6:],
                               atol=WEIGHT_ATOL)
    assert keep["pcg"]["iterations"] > 3
    assert keep["pcg"]["relative_residual"] < 1e-3
    stages = [r["stage"] for r in timer.records]
    assert stages == ["smplh_forward", "project_joints", "render_value_maps",
                      "warp", "normal2depth"]


def test_cached_branch(jax_chain, models, port_chain, tmp_path):
    """cache=True: tpubody's side-car files are written, the results equal
    the device-resident branch's (the stitch weights up to its float16),
    and a second run computes nothing."""
    (J0, w0, f0, b0), _, _ = port_chain
    (J1, w1, f1, b1), keep, _ = run_helper(jax_chain, models, tmp_path, True)
    for name, shape in (("smplh_value.npy", (SIZE, SIZE, 30)),
                        ("warp_and_filled.npy", (SIZE, SIZE, 30)),
                        ("depth_front.npy", (SIZE, SIZE)),
                        ("depth_back.npy", (SIZE, SIZE))):
        assert np.load(tmp_path / name).shape == shape
    np.testing.assert_array_equal(J0, J1)
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(b0, b1)
    np.testing.assert_allclose(w0, w1, atol=2.0 ** -11)
    assert isinstance(keep["warp"], np.ndarray) and keep["pcg"]
    (_, w2, f2, _), keep2, _ = run_helper(jax_chain, models, tmp_path, True)
    assert keep2["pcg"] == {}           # a hit: nothing was solved
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(w1, w2)
    # the artifacts are arrays tpubody's cache reads back under its own hash
    jsc = jcache.StageCache(str(tmp_path))
    h = jcache.digest(np.load(tmp_path / "warp_and_filled.npy")[..., :6],
                      jax_chain["mask_u8"])
    hit = jsc.get("normal2depth", h, ["depth_front.npy", "depth_back.npy"])
    assert hit is not None
    np.testing.assert_array_equal(hit["depth_front.npy"], f1)


def run_reconstruct(jc, models, out_dir=None, **kw):
    return TRc.reconstruct(jc["front_rgb"], jc["back_rgb"], jc["mask_u8"],
                           TRc.FitResult(*jc["fit"]), models[0], models[1],
                           out_dir=out_dir, device="cpu", **kw)


@pytest.mark.parametrize("replace_hands", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_reconstruct_completes(jax_chain, models, tmp_path, cache,
                               replace_hands, capfd):
    """Both cache modes run every stage and write tpubody's artefacts,
    which load back; the result is the port's types."""
    timer = StageTimer()
    res = run_reconstruct(jax_chain, models, str(tmp_path), cache=cache,
                          timer=timer, replace_hands=replace_hands)
    stages = [r["stage"] for r in timer.records]
    assert stages == ["smplh_forward", "project_joints", "render_value_maps",
                      "warp", "normal2depth", "stitch", "rig"] \
        + ["replace_hands"] * replace_hands + ["save"]
    assert isinstance(res, TRc.ReconstructResult)
    assert type(res.avatar) is TRig.RiggedAvatar
    n = res.points.shape[0]
    assert res.points.shape == (n, 30) and res.joints3d.shape == (24, 3)
    assert np.isfinite(res.avatar.v_template).all()
    np.testing.assert_allclose(res.avatar.weights.sum(axis=1), 1.0,
                               atol=1e-9)
    pkl = "replace_hands_recover.pkl" if replace_hands else "or_recover.pkl"
    for name in ("points.npy", "faces.npy", "J_3d.npy", pkl, "out.ply",
                 "out.glb"):
        assert (tmp_path / name).exists(), name
    assert (tmp_path / "depth_front.npy").exists() == cache
    np.testing.assert_array_equal(np.load(tmp_path / "points.npy"),
                                  res.points)
    np.testing.assert_array_equal(np.load(tmp_path / "faces.npy"), res.faces)
    np.testing.assert_array_equal(np.load(tmp_path / "J_3d.npy"),
                                  res.joints3d)
    avatar = TRig.load_avatar(str(tmp_path / pkl))
    np.testing.assert_array_equal(avatar.v_template, res.avatar.v_template)
    verts, faces, _ = TMio.read_ply(str(tmp_path / "out.ply"))
    np.testing.assert_allclose(verts, res.points[:, :3], atol=1e-6)
    np.testing.assert_array_equal(faces, res.faces)
    gltf, _ = TGl.read_glb(str(tmp_path / "out.glb"))
    assert len(gltf["skins"][0]["joints"]) == 24
    assert ("hand replacement skipped" in capfd.readouterr().err) \
        == replace_hands
    # without out_dir the cache is off: the same mesh, the stitch weights
    # up to the float16 the device-resident branch carries them in
    again = run_reconstruct(jax_chain, models, cache=cache,
                            replace_hands=replace_hands)
    np.testing.assert_array_equal(again.faces, res.faces)
    np.testing.assert_array_equal(again.points[:, :6], res.points[:, :6])
    np.testing.assert_allclose(again.points[:, 6:], res.points[:, 6:],
                               atol=2.0 ** -11)


@pytest.fixture(scope="module")
def tpubody_result(jax_chain):
    jc = jax_chain
    mp = pytest.MonkeyPatch()
    torch_recon_common.use_native_geometry(mp)
    try:
        return JR.reconstruct(jc["front_rgb"], jc["back_rgb"], jc["mask_u8"],
                              jc["fit"], jc["smplh"], jc["smpl"],
                              cache=False, replace_hands=True)
    finally:
        mp.undo()


def test_reconstruct_matches_tpubodys(jax_chain, models, port_chain,
                                      tpubody_result, capfd):
    """Free-running, cache off, hand graft asked for: tpubody's
    reconstruct and the port's on the same inputs (the bars are in the
    module's docstring)."""
    want = tpubody_result
    got = run_reconstruct(jax_chain, models, cache=False, replace_hands=True)
    err = capfd.readouterr().err
    assert err.count("hand replacement skipped (wrist section failed") == 1
    (_, _, _, _), keep, _ = port_chain
    assert np.array_equal((keep["value"].numpy() == 1.0).all(-1),
                          (jax_chain["value"] == 1.0).all(-1))
    rng = float(jax_chain["front"].max() - jax_chain["front"].min())
    assert got.points.shape == want.points.shape
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.points[:, :3], want.points[:, :3],
                               atol=DEPTH_REL * rng)
    np.testing.assert_array_equal(got.points[:, 3:6], want.points[:, 3:6])
    np.testing.assert_allclose(got.points[:, 6:], want.points[:, 6:],
                               atol=WEIGHT_ATOL)
    np.testing.assert_allclose(got.joints3d, want.joints3d,
                               atol=DEPTH_REL * rng)
    np.testing.assert_allclose(got.avatar.v_template, want.avatar.v_template,
                               atol=AVATAR_ATOL)
    np.testing.assert_allclose(got.avatar.joints, want.avatar.joints,
                               atol=AVATAR_ATOL)
    np.testing.assert_array_equal(got.avatar.faces, want.avatar.faces)
    # the degrade branch kept the rigged avatar as it was
    assert got.avatar.v_template.shape[0] == got.points.shape[0]


def test_result_from_numpy_takes_tpubodys_result(tpubody_result):
    res = TRc.result_from_numpy(tpubody_result)
    assert type(res) is TRc.ReconstructResult
    assert type(res.avatar) is TRig.RiggedAvatar
    for a, b in zip(res.avatar, tpubody_result.avatar):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(res.points, tpubody_result.points)


def test_load_test_dir_reads_tpubodys_fixture(tmp_path):
    """A fixture directory written by tpubody's demo loads the same in
    both packages."""
    from tpubody.pipelines import demo as jdemo

    jdemo.make_fixture(str(tmp_path), size=64, verts=1100)
    got = TRc.load_test_dir(str(tmp_path))
    want = JR.load_test_dir(str(tmp_path))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    os.remove(tmp_path / "mask.png")
    with pytest.raises(FileNotFoundError):
        TRc.load_test_dir(str(tmp_path))


def test_reconstruct_defaults_to_the_card(jax_chain, models, monkeypatch):
    """reconstruct() without ``device`` runs on the card: where there is
    none it raises resolve's RuntimeError before any stage runs, and it
    does not fall back to the CPU the body models live on."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    ran = []
    monkeypatch.setattr(TRc, "_device_stages",
                        lambda *a, **k: ran.append(a))
    jc = jax_chain
    rgb = np.zeros((SIZE, SIZE, 3), np.uint8)
    assert models[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TRc.reconstruct(rgb, rgb, jc["mask_u8"], TRc.FitResult(*jc["fit"]),
                        models[0], models[1], cache=False)
    assert ran == []


@pytest.mark.parametrize("writer,reader", [(TRc, JR), (JR, TRc), (TRc, TRc)])
def test_fit_pickle_is_read_by_either_package(jax_chain, tmp_path, writer,
                                              reader):
    path = str(tmp_path / "smplh.pkl")
    writer.save_fit_pickle(path, writer.FitResult(*jax_chain["fit"]))
    got = reader.load_fit_pickle(path)
    for a, b in zip(got, jax_chain["fit"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got._fields == JR.FitResult._fields


def test_digest_and_stage_cache_equal_tpubodys(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.random((5, 7)).astype(np.float32)
    b = rng.integers(0, 9, (4,))
    assert digest(a, b, None, H=3, W=4) == jcache.digest(a, b, None, H=3, W=4)
    assert digest(a) != digest(a.astype(np.float64))
    sc = StageCache(str(tmp_path))
    calls = []

    def compute():
        calls.append(1)
        return {"x.npy": a}

    for _ in range(2):
        out = sc.run("stage", digest(a), ["x.npy"], compute)
        np.testing.assert_array_equal(out["x.npy"], a)
    assert len(calls) == 1
    assert sc.get("stage", digest(b), ["x.npy"]) is None
    assert StageCache(str(tmp_path), enabled=False).get(
        "stage", digest(a), ["x.npy"]) is None


def test_stage_timer_records_and_reports(tmp_path):
    timer = StageTimer()
    with timer.stage("a"):
        torch.ones(4).sum()
    with timer.stage("b/c"):
        pass
    assert [r["stage"] for r in timer.records] == ["a", "b/c"]
    assert all(r["seconds"] >= 0 for r in timer.records)
    assert "TOTAL" in timer.report().splitlines()[-1]
    timer.dump(str(tmp_path / "t.json"))
    import json

    assert json.load(open(tmp_path / "t.json")) == timer.records
