"""python -m tpubody_torch.cli on the CPU (``--device cpu``).

``reconstruct`` runs as a process on a fixture that tpubody's demo wrote
at 96^2 (the reference layout) and writes tpubody's artefact names;
``demo`` and ``export-glb`` run in this process, the GLB byte-equal to
tpubody's CLI's for the same avatar and clip.  The fitting, HMR and
animation commands are held to their pipelines' arguments (the pipelines
themselves are tested in their own files), with the fit pipelines
replaced by recorders: a whole fit at FitConfig() defaults is too long for
a CPU test.  Without ``--device`` every command runs on the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpubody import cli as jcli
from tpubody.io import motion as jmotion
from tpubody_torch import cli
from tpubody_torch.mesh import gltf as TGl
from tpubody_torch.mesh import rigging as TRig

from tests.test_torch_gltf import avatar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reconstruct_as_a_process(tmp_path):
    from tpubody.pipelines import demo as jdemo

    fixture = str(tmp_path / "fixture")
    jdemo.make_fixture(fixture, size=96, verts=1100)
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "tpubody_torch.cli", "--device", "cpu",
         "reconstruct", fixture, "--out", out, "--replace-hands"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    for name in ("points.npy", "faces.npy", "J_3d.npy",
                 "replace_hands_recover.pkl", "out.ply", "out.glb",
                 "depth_front.npy", "warp_and_filled.npy"):
        assert os.path.exists(os.path.join(out, name)), name
    assert "TOTAL" in res.stdout and "stitch" in res.stdout
    avatar_ = TRig.load_avatar(os.path.join(out,
                                            "replace_hands_recover.pkl"))
    assert np.isfinite(avatar_.v_template).all()


def test_demo_command(tmp_path, capsys):
    out = str(tmp_path / "demo")
    assert cli.main(["--device", "cpu", "demo", out, "--size", "96",
                     "--verts", "1100", "--frames", "0"]) == 0
    printed = capsys.readouterr().out
    for name in ("replace_hands_recover.pkl", "out.ply", "avatar.glb",
                 "smplh.pkl"):
        assert name in printed and os.path.exists(os.path.join(out, name))


@pytest.mark.parametrize("clip_kind", ["none", "mixamo", "amass"])
def test_export_glb_equals_tpubodys_cli(tmp_path, clip_kind):
    t_av, j_av = avatar(seed=3)
    pkl = str(tmp_path / "avatar.pkl")
    TRig.save_avatar(pkl, t_av)
    extra = []
    rng = np.random.default_rng(0)
    if clip_kind == "mixamo":
        clip = str(tmp_path / "result.pkl")
        jmotion.save_mixamo(clip, rng.normal(scale=0.2, size=(4, 24, 3)),
                            fps=24.0)
        extra = ["--clip", clip]
    elif clip_kind == "amass":
        clip = str(tmp_path / "clip.npz")
        np.savez(clip, poses=rng.normal(scale=0.2, size=(6, 156)),
                 trans=rng.normal(scale=0.1, size=(6, 3)),
                 mocap_framerate=60.0)
        extra = ["--clip", clip, "--stride", "2"]
    t_out, j_out = str(tmp_path / "t.glb"), str(tmp_path / "j.glb")
    assert cli.main(["export-glb", pkl, t_out] + extra) == 0
    assert jcli.main(["export-glb", pkl, j_out] + extra) == 0
    assert open(t_out, "rb").read() == open(j_out, "rb").read()
    gltf, _ = TGl.read_glb(t_out)
    assert ("animations" in gltf) == (clip_kind != "none")


def test_amc_clips_are_refused(tmp_path):
    t_av, _ = avatar(seed=3)
    pkl = str(tmp_path / "avatar.pkl")
    TRig.save_avatar(pkl, t_av)
    with pytest.raises(SystemExit, match="amc"):
        cli.main(["export-glb", pkl, str(tmp_path / "a.glb"), "--clip",
                  str(tmp_path / "walk.amc")])


def test_animate_command(tmp_path):
    t_av, _ = avatar(seed=3)
    pkl = str(tmp_path / "avatar.pkl")
    TRig.save_avatar(pkl, t_av)
    clip = str(tmp_path / "result.pkl")
    jmotion.save_mixamo(clip, np.random.default_rng(1).normal(
        scale=0.2, size=(2, 24, 3)), fps=12.0)
    out = str(tmp_path / "a.mp4")
    assert cli.main(["--device", "cpu", "animate", pkl, clip, out,
                     "--size", "64", "--cam-z", "3.0"]) == 0
    assert os.path.getsize(out) > 0


@pytest.mark.parametrize("argv,target,check", [
    (["gen-smplh", "img.png", "kp.json", "outdir", "--config", "c.yaml"],
     ("gen_smplh", "gen_smplh"),
     lambda a, k: a == ("img.png", "kp.json", "outdir")
     and k["config_yaml"] == "c.yaml"),
    (["refine", "img.png", "kp.json", "outdir", "--hmr-ckpt", "h.pt"],
     ("refine", "refine"),
     lambda a, k: a == ([("img.png", "kp.json", "outdir")],)
     and k["hmr_ckpt"] == "h.pt"),
])
def test_fit_commands_reach_their_pipelines(argv, target, check,
                                            monkeypatch):
    import importlib

    mod = importlib.import_module(f"tpubody_torch.pipelines.{target[0]}")
    calls = []
    monkeypatch.setattr(mod, target[1],
                        lambda *a, **k: calls.append((a, k)))
    assert cli.main(["--device", "cpu"] + argv) == 0
    (a, k), = calls
    assert check(a, k) and k["device"] == "cpu"


def test_gen_smplh_batch_skips_incomplete_dirs(tmp_path, monkeypatch):
    from tpubody_torch.pipelines import gen_smplh

    good, bad = tmp_path / "good", tmp_path / "bad"
    good.mkdir(), bad.mkdir()
    (good / "front_rgb.png").write_bytes(b"")
    (good / "0_keypoints.json").write_text("{}")
    calls = []
    monkeypatch.setattr(gen_smplh, "gen_smplh_batch",
                        lambda items, **k: calls.append((items, k)))
    assert cli.main(["--device", "cpu", "gen-smplh-batch", str(good),
                     str(bad)]) == 0
    (items, k), = calls
    assert items == [(str(good / "front_rgb.png"),
                      str(good / "0_keypoints.json"), str(good))]
    assert k["device"] == "cpu"
    assert cli.main(["gen-smplh-batch", str(bad)]) == 1


def test_fit_video_writes_the_sequence(tmp_path, monkeypatch):
    from tpubody_torch.fit import keypoints as kp_lib
    from tpubody_torch.fit import smplify

    rng = np.random.default_rng(2)
    for i in range(3):
        kp_lib.write_openpose_json(str(tmp_path / f"{i}_keypoints.json"),
                                   rng.uniform(0, 100, (25, 3)),
                                   rng.uniform(0, 100, (21, 3)),
                                   rng.uniform(0, 100, (21, 3)))
    T = 3

    def fake(model, kps, center, config, chained, device):
        assert kps.shape == (T, 67, 3) and device == "cpu" and chained
        return smplify.FitBatchOutput(
            pose=np.zeros((T, 156)), shape=np.zeros((T, 10)),
            camera_translation=np.zeros((T, 3)),
            camera_center=np.zeros((T, 2)), camera_fx=5000.0,
            pose_embedding=np.zeros((T, 32)), loss=np.ones(T))

    monkeypatch.setattr(smplify, "fit_sequence", fake)
    out, clip = str(tmp_path / "fit.npz"), str(tmp_path / "result.pkl")
    assert cli.main(["--device", "cpu", "fit-video",
                     str(tmp_path / "*_keypoints.json"), out, "--verts",
                     "1100", "--clip-out", clip]) == 0
    assert np.load(out)["pose"].shape == (T, 156)
    assert jmotion.read_mixamo(clip).poses.shape == (T, 24, 3)


def test_infer_command(tmp_path):
    import cv2

    img = str(tmp_path / "person.png")
    cv2.imwrite(img, np.random.default_rng(0).integers(
        0, 255, (64, 48, 3), dtype=np.uint8))
    out = str(tmp_path / "meshes")
    assert cli.main(["--device", "cpu", "infer", img, "--out", out,
                     "--format", "ply"]) == 0
    assert os.path.exists(os.path.join(out, "person.ply"))
    assert np.load(os.path.join(out, "params.npz"))["rotmats"].shape \
        == (1, 24, 3, 3)


def test_commands_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["demo", str(tmp_path / "d"), "--size", "64"])


def _amc_files(tmp_path, frames=3):
    from tests.test_asf import SAMPLE_AMC, SAMPLE_ASF

    asf = tmp_path / "skel.asf"
    amc = tmp_path / "walk.amc"
    asf.write_text(SAMPLE_ASF)
    body = SAMPLE_AMC.split("1\n", 1)[0]
    for f in range(frames):
        body += (f"{f + 1}\nroot {0.1 * f} 16.0 -2.0 {5.0 * f} -5.0 3.0\n"
                 f"lfemur {10.0 + 5 * f} -8.0 5.0\nltibia {20.0 + 7 * f}\n")
    amc.write_text(body)
    return str(asf), str(amc)


def test_export_glb_amc_equals_tpubodys_cli(tmp_path):
    t_av, _ = avatar(seed=3)
    pkl = str(tmp_path / "avatar.pkl")
    TRig.save_avatar(pkl, t_av)
    asf, amc = _amc_files(tmp_path)
    extra = ["--clip", amc, "--asf", asf, "--fps", "30"]
    t_out, j_out = str(tmp_path / "t.glb"), str(tmp_path / "j.glb")
    assert cli.main(["export-glb", pkl, t_out] + extra) == 0
    assert jcli.main(["export-glb", pkl, j_out] + extra) == 0
    assert open(t_out, "rb").read() == open(j_out, "rb").read()
    assert "animations" in TGl.read_glb(t_out)[0]


def test_animate_amc_clip(tmp_path):
    import cv2

    t_av, _ = avatar(seed=3)
    pkl = str(tmp_path / "avatar.pkl")
    TRig.save_avatar(pkl, t_av)
    asf, amc = _amc_files(tmp_path, frames=4)
    out = str(tmp_path / "a.mp4")
    assert cli.main(["--device", "cpu", "animate", pkl, amc, "--asf", asf,
                     out, "--size", "64", "--stride", "1",
                     "--cam-z", "3.0"]) == 0
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4


def test_train_hmr_command(tmp_path, capsys):
    from tpubody_torch.models import hmr as thmr
    from tpubody_torch.models import hmr_train as ttrain
    from tpubody_torch.utils import checkpoint as tckpt
    from tpubody_torch.utils.metrics import read_jsonl

    out = str(tmp_path / "hmr.pt")
    assert cli.main(["--device", "cpu", "train-hmr", "--synthetic", "8",
                     "--batch", "4", "--size", "64", "--steps", "2",
                     "--out", out]) == 0
    printed = capsys.readouterr().out
    assert "step 0: loss" in printed and "eval: mpjpe" in printed
    recs = read_jsonl(out + "_metrics.jsonl")
    assert [r["tag"] for r in recs] == ["train", "train", "eval"]
    assert all(np.isfinite(r["loss"]) for r in recs[:2])
    assert {"mpjpe", "pa_mpjpe", "pve"} <= set(recs[2])
    template = ttrain.create_train_state(
        thmr.create_hmr(dtype=torch.float32, device="cpu"))
    state = tckpt.restore_train_state(out, template)
    assert state.step == 2
    assert int(state.model.state_dict()[
        "backbone.bn1.num_batches_tracked"]) == 2


def test_train_pose2d_then_detect_pose(tmp_path, capsys):
    import cv2

    from tpubody_torch.fit import keypoints as tkp
    from tpubody_torch.utils import checkpoint as tckpt

    ckpt = str(tmp_path / "pose2d.pt")
    assert cli.main(["--device", "cpu", "train-pose2d", "--out", ckpt,
                     "--steps", "3", "--batch", "2", "--size", "32",
                     "--features", "8", "--chunk", "2",
                     "--domain-rand"]) == 0
    assert "pixel err:" in capsys.readouterr().out
    raw = tckpt.restore_pytree(ckpt)
    assert int(raw["meta"]["n_keypoints"]) == 24
    assert isinstance(raw["meta"]["features"], np.ndarray)

    img = str(tmp_path / "person.png")
    cv2.imwrite(img, np.random.default_rng(0).integers(
        0, 255, (80, 60, 3), dtype=np.uint8))
    js = str(tmp_path / "0_keypoints.json")
    assert cli.main(["--device", "cpu", "detect-pose", img, js, "--size",
                     "32", "--ckpt", ckpt]) == 0
    kp = tkp.read_openpose_json(js, use_hands=True, use_face=False)
    assert kp.keypoints.shape[0] == 67
    assert np.isfinite(kp.keypoints).all()
    assert (kp.keypoints[24:, 2] == 0).all()     # padded slots


def test_detect_pose_without_ckpt_warns(tmp_path, capsys):
    import cv2

    img = str(tmp_path / "person.png")
    cv2.imwrite(img, np.zeros((40, 40, 3), np.uint8))
    js = str(tmp_path / "k.json")
    assert cli.main(["--device", "cpu", "detect-pose", img, js, "--size",
                     "32"]) == 0
    assert "untrained weights" in capsys.readouterr().err
