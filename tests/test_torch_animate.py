"""tpubody_torch.pipelines.animate against tpubody.pipelines.animate on the
sphere avatar: the frames each package hands to its MP4 writer are
recorded and compared.

Tolerances: uint8 frames within 1 LSB on at least 99.9% of the values
(float32 sums in another order cross a rounding step; the rest are
sub-pixel edge pixels).  Crop-transfer frames equal full-frame frames
exactly: the crop changes which bytes are copied, not the image.
"""
import os

import numpy as np
import pytest
import torch

from tpubody.io import motion as jmotion
from tpubody.pipelines import animate as janimate
from tpubody.render import video as jvideo
from tpubody_torch.io import motion as tmotion
from tpubody_torch.mesh import rigging as trigging
from tpubody_torch.pipelines import animate as tanimate
from tpubody_torch.render import video as tvideo

from tests.test_torch_rigging import both_avatars

torch.set_num_threads(1)

CAM = np.array([0.0, 0.0, 3.0])
LSB_SHARE = 0.999


def clip_arrays(n, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=scale, size=(n, 24, 3)),
            rng.normal(scale=0.02, size=(n, 3)))


@pytest.fixture
def recorded(monkeypatch):
    """Records what either package's VideoWriter is handed, by output
    path: ("rgb", uint8 HWC) or ("i420", uint8 planes)."""
    frames = {}
    for mod in (jvideo, tvideo):
        w, wi = mod.VideoWriter.write, mod.VideoWriter.write_i420

        def rec_write(self, frame, _w=w, _q=mod.quantize_u8):
            frames.setdefault(self.path, []).append(
                ("rgb", _q(np.asarray(frame)).copy()))
            _w(self, frame)

        def rec_i420(self, planes, _wi=wi):
            frames.setdefault(self.path, []).append(
                ("i420", np.array(planes)))
            _wi(self, planes)

        monkeypatch.setattr(mod.VideoWriter, "write", rec_write)
        monkeypatch.setattr(mod.VideoWriter, "write_i420", rec_i420)
    return frames


def stack(frames, path, kind):
    assert {k for k, _ in frames[path]} == {kind}
    return np.stack([f for _, f in frames[path]])


def assert_within_one_lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    assert (d <= 1).mean() >= LSB_SHARE, (d <= 1).mean()


def test_animate_video_writes_mp4_and_matches_tpubody(tmp_path, recorded):
    """The tiled path at 128^2 with the defaults (crop transfer on): an
    MP4 is written, and the frames equal tpubody's within 1 LSB.  5 frames
    in blocks of 4: the last block is padded and trimmed."""
    jav, tav = both_avatars()
    poses, trans = clip_arrays(5, 7)
    pj, pt = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    kw = dict(size=128, focal=300.0, cam_t=CAM, chunk=4)
    janimate.animate_video(jav, jmotion.MotionClip(poses, trans, 30.0), pj,
                           **kw)
    out = tanimate.animate_video(tav, tmotion.MotionClip(poses, trans, 30.0),
                                 pt, device="cpu", **kw)
    assert out == pt and os.path.getsize(pt) > 500
    want, got = stack(recorded, pj, "rgb"), stack(recorded, pt, "rgb")
    assert got.shape == (5, 128, 128, 3)
    assert_within_one_lsb(got, want)
    assert (got < 255).any(axis=-1).mean() > 0.05          # a body is there
    assert not np.array_equal(got[0], got[1])


def test_crop_transfer_frames_bit_exact(tmp_path, recorded):
    _, tav = both_avatars()
    clip = tmotion.MotionClip(*clip_arrays(3, 11), 30.0)
    for crop in (False, True):
        tanimate.animate_video(
            tav, clip, str(tmp_path / f"ct_{crop}.mp4"), size=128,
            focal=300.0, cam_t=CAM, chunk=2, crop_transfer=crop,
            i420_transfer=False, device="cpu")
    a = stack(recorded, str(tmp_path / "ct_False.mp4"), "rgb")
    b = stack(recorded, str(tmp_path / "ct_True.mp4"), "rgb")
    np.testing.assert_array_equal(a, b)


def test_i420_transfer_matches_tpubody(tmp_path, recorded):
    """With the crop off the path hands planar I420 to the writer; the
    planes equal tpubody's within 1 LSB."""
    jav, tav = both_avatars()
    poses, trans = clip_arrays(3, 13)
    pj, pt = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    kw = dict(size=128, focal=300.0, cam_t=CAM, chunk=2, crop_transfer=False)
    janimate.animate_video(jav, jmotion.MotionClip(poses, trans, 30.0), pj,
                           **kw)
    tanimate.animate_video(tav, tmotion.MotionClip(poses, trans, 30.0), pt,
                           device="cpu", **kw)
    want, got = stack(recorded, pj, "i420"), stack(recorded, pt, "i420")
    assert got.shape == (3, 192, 128)
    assert_within_one_lsb(got, want)
    assert os.path.getsize(pt) > 500


def test_fragment_path_for_sizes_that_do_not_tile(tmp_path, recorded):
    """64x64 frames do not tile into 8x128 blocks: the fragment renderer
    drives the video (float frames, quantized at the writer)."""
    jav, tav = both_avatars()
    poses, trans = clip_arrays(3, 3)
    pj, pt = str(tmp_path / "j.mp4"), str(tmp_path / "t.mp4")
    kw = dict(size=64, focal=150.0, cam_t=CAM, chunk=2, stride=1)
    janimate.animate_video(jav, jmotion.MotionClip(poses, trans, 30.0), pj,
                           **kw)
    tanimate.animate_video(tav, tmotion.MotionClip(poses, trans, 30.0), pt,
                           device="cpu", **kw)
    assert_within_one_lsb(stack(recorded, pt, "rgb"),
                          stack(recorded, pj, "rgb"))


def test_shading_and_lod_pass_through(tmp_path, recorded):
    _, tav = both_avatars()
    clip = tmotion.MotionClip(*clip_arrays(2, 5), 30.0)
    kw = dict(size=128, focal=300.0, cam_t=CAM, chunk=2, device="cpu")
    paths = {}
    for name, extra in (("gouraud", {}), ("phong", {"shading": "phong"}),
                        ("lod", {"lod": 100})):
        paths[name] = str(tmp_path / f"{name}.mp4")
        tanimate.animate_video(tav, clip, paths[name], **kw, **extra)
    g, p, lod = (stack(recorded, paths[n], "rgb")
                 for n in ("gouraud", "phong", "lod"))
    # vertex- and pixel-shaded frames are close but not the same frames
    assert not np.array_equal(g, p)
    assert np.abs(g.astype(int) - p.astype(int)).mean() < 0.02 * 255
    assert not np.array_equal(g, lod)
    assert ((g < 255).any(-1) == (p < 255).any(-1)).mean() > 0.999
    render, chunk, i420 = tanimate._block_renderer(
        tav, None, CAM, 128, 300.0, None, 2, i420=True, device="cpu")
    assert i420 and chunk == 2
    _, _, i420_frag = tanimate._block_renderer(
        tav, None, CAM, 64, 150.0, None, 2, i420=True, device="cpu")
    assert not i420_frag                     # only the tiled path has it
    with pytest.raises(ValueError, match="background"):
        tanimate._block_renderer(tav, np.ones((64, 64, 3)), CAM, 128, 300.0,
                                 None, 2, device="cpu")


def test_from_files_and_batch(tmp_path, recorded):
    """animate_from_amass / _mixamo / _mixamo_batch from files written by
    tpubody (avatar pickle, Mixamo pickle) and by numpy (AMASS npz)."""
    from tpubody.mesh import rigging as jrigging

    jav, tav = both_avatars()
    avp = str(tmp_path / "avatar.pkl")
    jrigging.save_avatar(avp, jav)
    rng = np.random.default_rng(2)
    amass = str(tmp_path / "clip.npz")
    np.savez(amass, poses=rng.normal(scale=0.05, size=(6, 156)),
             trans=rng.normal(scale=0.02, size=(6, 3)),
             mocap_framerate=60.0)
    kw = dict(size=128, focal=300.0, cam_t=CAM, chunk=2, device="cpu")
    out = tanimate.animate_from_amass(avp, amass, str(tmp_path / "a.mp4"),
                                      **kw)
    assert len(recorded[out]) == 3                       # stride 2
    want = janimate.animate_from_amass(avp, amass, str(tmp_path / "ja.mp4"),
                                       size=128, focal=300.0, cam_t=CAM,
                                       chunk=2)
    assert_within_one_lsb(stack(recorded, out, "rgb"),
                          stack(recorded, want, "rgb"))

    root = tmp_path / "mixamo"
    for name in ("0007", "0020"):
        (root / name).mkdir(parents=True)
        jmotion.save_mixamo(str(root / name / "result.pkl"),
                            rng.normal(scale=0.05, size=(3, 24, 3)), fps=30.0)
    (root / "notaclip").mkdir()                          # no result.pkl
    one = tanimate.animate_from_mixamo(
        avp, str(root / "0007" / "result.pkl"), str(tmp_path / "m.mp4"),
        **kw)
    assert len(recorded[one]) == 3
    outs = tanimate.animate_mixamo_batch(avp, str(root), str(tmp_path), **kw)
    assert [os.path.basename(o) for o in outs] == ["or_0007.mp4",
                                                   "or_0020.mp4"]
    assert all(os.path.getsize(o) > 400 for o in outs)
    np.testing.assert_array_equal(stack(recorded, outs[0], "rgb"),
                                  stack(recorded, one, "rgb"))


@pytest.mark.parametrize("size,focal", [(128, 300.0), (64, 150.0)])
def test_orbit_video(tmp_path, recorded, size, focal):
    _, tav = both_avatars()
    out = tanimate.orbit_video(tav, str(tmp_path / "orbit.mp4"), n_frames=4,
                               size=size, focal=focal, cam_t=CAM, chunk=3,
                               device="cpu")
    frames = stack(recorded, out, "rgb")
    assert frames.shape == (4, size, size, 3)
    assert os.path.getsize(out) > 400
    assert not np.array_equal(frames[0], frames[1])     # the view turns


def test_deferred_options_raise_and_the_card_is_the_default(tmp_path):
    _, tav = both_avatars()
    clip = tmotion.MotionClip(*clip_arrays(2, 1), 30.0)
    out = str(tmp_path / "x.mp4")
    with pytest.raises(NotImplementedError, match="slice E"):
        tanimate.animate_video(tav, clip, out, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="slice E"):
        tanimate.animate_video(tav, clip, out, multihost=True, device="cpu")
    assert not os.path.exists(out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tanimate.animate_video(tav, clip, out, size=128)


def test_mux_failure_surfaces(tmp_path, monkeypatch):
    """An error on the mux thread stops the block loop and is raised from
    animate_video."""
    _, tav = both_avatars()
    clip = tmotion.MotionClip(*clip_arrays(6, 1), 30.0)

    def boom(self, frame):
        raise OSError("disk full")

    monkeypatch.setattr(tvideo.VideoWriter, "write", boom)
    with pytest.raises(OSError, match="disk full"):
        tanimate.animate_video(tav, clip, str(tmp_path / "x.mp4"), size=128,
                               focal=300.0, cam_t=CAM, chunk=2, device="cpu")


def test_to_hwc():
    a = np.zeros((2, 3, 8, 16), np.uint8)
    assert tanimate._to_hwc(a).shape == (2, 8, 16, 3)
    b = np.zeros((2, 8, 16, 3), np.uint8)
    assert tanimate._to_hwc(b) is b
    planes = np.zeros((2, 12, 16), np.uint8)
    assert tanimate._to_hwc(planes) is planes
    assert trigging.IGNORED_JOINTS == (13, 14, 22, 23)
