"""tpubody_torch.render.tiled_raster against tpubody.render.pallas_raster
(its Pallas kernel in interpret mode on the CPU) and against the port's
own fragment rasterizer, on the 64x128 scenes of
tests/test_pallas_raster.py.

Tolerances:
  * binning: chunk ranges, valid-chunk and overflow counts equal; the
    coefficient table, re-laid-out to tpubody's (MAXC, 4, G*CF), within a
    relative 1e-6 (both sides evaluate the same float32 expressions);
  * the plain version of the kernel vs the Pallas kernel on the SAME table:
    coverage and winning face equal at every pixel; the quantized depth in
    the key within 16 steps of up to 2^26 (the Pallas kernel sums
    a*px + b*py + c as one dot product, the port as (a*px + b*py) + c: a
    few float32 roundings at that magnitude); attributes within 2e-5
    (they are O(1), but on these 10-pixel triangles their affine terms
    reach O(10) before they cancel, so one rounding that the two
    summation orders do not share is worth up to 1e-6 * 10; the largest
    difference on these scenes is 1.5e-5, one value of the 24-channel
    stack), and the depth rebuilt from the key likewise;
  * a rare edge pixel may flip between the two summation orders: none is
    allowed on these scenes.
The CUDA kernel runs only on a GPU: its test skips here and runs on the
card with
``python -m pytest --noconftest -p no:cacheprovider -k cuda tests/test_torch_tiled_raster.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tpubody.render import pallas_raster as PR
from tpubody_torch.render import raster as raster_lib
from tpubody_torch.render import tiled_raster as TR

from tests.test_torch_raster import scene

torch.set_num_threads(1)

H, W = 64, 128
T = (H // 8) * (W // 128)
TABLE_RTOL = 1e-6
ATTR_ATOL = 2e-5
DQ_STEPS = 16
MAXC = T * 5


def t(x):
    return torch.as_tensor(x)


def pallas_layout(table):
    """The port's (MAXC, CF, G, 3) table as tpubody's (MAXC, 4, lanes)."""
    MAXC_, CF, G, _ = table.shape
    lanes = G * CF + (-(G * CF)) % 128
    out = np.zeros((MAXC_, 4, lanes), np.float32)
    out[:, :3, :G * CF] = table.transpose(0, 3, 2, 1).reshape(MAXC_, 3, G * CF)
    return out


def bin_both(v, f, a, maxc=MAXC, sx=2, sy=5):
    want = PR._bin_fused(jnp.asarray(v), jnp.asarray(f), jnp.asarray(a), H, W,
                         maxc, sx, sy)
    got = TR._bin_fused(t(v)[None], t(f), t(a)[None], H, W, maxc, sx, sy)
    return got, want


SCENES = [(4, 40, 12, 6), (5, 30, 10, 3), (6, 40, 12, 24)]


@pytest.mark.parametrize("seed,n_faces,ext,C", SCENES)
def test_bin_fused_matches(seed, n_faces, ext, C):
    v, f, a = scene(n_faces, ext, seed, n_chan=C)
    (table, cstarts, nvalid, overflow, meta), \
        (jtab, jcst, jnv, jov, jmeta) = bin_both(v, f, a)
    assert tuple(table.shape) == (1, MAXC, TR.CF_FUSED, 5 + C, 3)
    assert cstarts.dtype == torch.int32 and nvalid.dtype == torch.int32
    np.testing.assert_array_equal(cstarts[0].numpy(), np.asarray(jcst))
    assert int(nvalid[0]) == int(jnv) and int(overflow[0]) == int(jov) == 0
    assert meta["fb"] == jmeta["fb"]
    assert meta["depth_levels"] == jmeta["depth_levels"]
    np.testing.assert_allclose(meta["zmin"].numpy()[0], np.asarray(jmeta["zmin"]))
    np.testing.assert_allclose(meta["zscale"].numpy()[0],
                               np.asarray(jmeta["zscale"]), rtol=1e-7)
    np.testing.assert_allclose(pallas_layout(table[0].numpy()),
                               np.asarray(jtab), rtol=TABLE_RTOL, atol=1e-9)


def test_bin_fused_batched_equals_per_frame():
    v, f, a = scene(30, 10, 5, n_chan=3)
    v2 = v.copy()
    v2[:, 0] += 7.0
    both = TR._bin_fused(t(np.stack([v, v2])), t(f), t(np.stack([a, a])),
                         H, W, MAXC, 2, 5)
    for i, vv in enumerate((v, v2)):
        one = TR._bin_fused(t(vv)[None], t(f), t(a)[None], H, W, MAXC, 2, 5)
        for x, y in zip(both[:4], one[:4]):
            assert torch.equal(x[i], y[0])


def piled_scene():
    """400 faces piled on one tile: 13 chunks of 32 (after the piled
    scene of tests/test_pallas_raster.py)."""
    rng = np.random.default_rng(3)
    v = np.stack([rng.uniform(4, 100, 1200), rng.uniform(1, 6, 1200),
                  rng.uniform(1, 2, 1200)], 1).astype(np.float32)
    f = np.arange(1200).reshape(400, 3).astype(np.int32)
    a = rng.uniform(size=(1200, 3)).astype(np.float32)
    return v, f, a


def test_bin_fused_overflow_matches():
    """A budget of one chunk per tile: the same chunks are dropped (the
    sort is stable on both sides) and the same count is reported."""
    v, f, a = piled_scene()
    (table, cstarts, nvalid, overflow, _), (jtab, jcst, jnv, jov, _) = \
        bin_both(v, f, a, maxc=T)
    assert int(overflow[0]) == int(jov) > 0
    assert int(nvalid[0]) == int(jnv) > T
    np.testing.assert_array_equal(cstarts[0].numpy(), np.asarray(jcst))
    np.testing.assert_allclose(pallas_layout(table[0].numpy()),
                               np.asarray(jtab), rtol=TABLE_RTOL, atol=1e-9)


def assert_keys_agree(win, jwin, fb):
    win, jwin = np.asarray(win), np.asarray(jwin)
    hit, jhit = win != TR.INT32_MAX, jwin != TR.INT32_MAX
    np.testing.assert_array_equal(hit, jhit)
    mask = (1 << fb) - 1
    np.testing.assert_array_equal((win & mask)[hit], (jwin & mask)[hit])
    ddq = np.abs((win >> fb).astype(np.int64) - (jwin >> fb))[hit]
    assert ddq.max() <= DQ_STEPS, ddq.max()
    return int(hit.sum())


@pytest.mark.parametrize("seed,n_faces,ext,C,maxc", [
    (4, 40, 12, 6, MAXC), (5, 30, 10, 3, MAXC), (6, 40, 12, 24, MAXC),
    (None, 400, 0, 3, T)])
def test_reference_matches_pallas_kernel_on_same_table(seed, n_faces, ext, C,
                                                       maxc):
    v, f, a = piled_scene() if seed is None else scene(n_faces, ext, seed,
                                                       n_chan=C)
    table, cstarts, _, _, meta = TR._bin_fused(
        t(v)[None], t(f), t(a)[None], H, W, maxc, 2, 5)
    fb, dl = meta["fb"], meta["depth_levels"]
    win, attr = TR.fused_raster_reference(table, cstarts, H, W, fb, dl)
    assert win.dtype == torch.int32 and tuple(win.shape) == (1, H, W)
    assert tuple(attr.shape) == (1, C, H, W)
    jwin, jattr = PR._fused_call(
        jnp.asarray(pallas_layout(table[0].numpy()))[None],
        jnp.asarray(cstarts.numpy()), H, W, C, fb, dl, True)
    assert assert_keys_agree(win, jwin, fb) > 100
    np.testing.assert_allclose(attr.numpy(), np.asarray(jattr)[:, :C],
                               atol=ATTR_ATOL)
    # CPU tensors take the plain version, and count no launch
    from tpubody_torch import native
    before = native.LAUNCHES["fused_raster"]
    win2, attr2 = TR.fused_raster(table, cstarts, H, W, fb, dl)
    assert torch.equal(win, win2) and torch.equal(attr, attr2)
    assert native.LAUNCHES["fused_raster"] == before


def test_reference_chunk_blocks_do_not_change_the_result(monkeypatch):
    v, f, a = piled_scene()
    table, cstarts, _, _, meta = TR._bin_fused(
        t(v)[None], t(f), t(a)[None], H, W, MAXC, 2, 5)
    args = (table, cstarts, H, W, meta["fb"], meta["depth_levels"])
    win, attr = TR.fused_raster_reference(*args)
    monkeypatch.setattr(TR, "_REF_CHUNK_BLOCK", 3)
    win3, attr3 = TR.fused_raster_reference(*args)
    assert torch.equal(win, win3) and torch.equal(attr, attr3)


@pytest.mark.parametrize("seed,n_faces,ext,C,channel_major", [
    (4, 40, 12, 6, False), (5, 30, 10, 3, True)])
def test_render_attrs_tiled_matches_tpubody_and_oracle(seed, n_faces, ext, C,
                                                       channel_major):
    v, f, a = scene(n_faces, ext, seed, n_chan=C)
    jattr, jmask, jdepth, jov = PR.render_attrs_tiled(
        jnp.asarray(v)[None], jnp.asarray(f), jnp.asarray(a), H, W,
        max_chunks=4, channel_major=channel_major, interpret=True)
    attr, mask, depth, ov = TR.render_attrs_tiled(
        t(v)[None], t(f), t(a), H, W, max_chunks=4,
        channel_major=channel_major)
    assert int(ov) == int(jov) == 0 and isinstance(ov, torch.Tensor)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(attr.numpy(), np.asarray(jattr),
                               atol=ATTR_ATOL)
    m = mask.numpy()
    np.testing.assert_allclose(depth.numpy()[m], np.asarray(jdepth)[m],
                               atol=ATTR_ATOL)
    assert np.isinf(depth.numpy()[~m]).all()
    # the port's own oracle: the fragment rasterizer (the bars of
    # tests/test_pallas_raster.py: coverage equal, attrs 1e-3, depth 1e-2)
    ref = raster_lib.rasterize(t(v), t(f), t(a), H, W, window=24)
    np.testing.assert_array_equal(mask[0].numpy(), ref.mask.numpy())
    got = attr[0].permute(1, 2, 0) if channel_major else attr[0]
    same = ref.mask.numpy()
    np.testing.assert_allclose(got.numpy()[same], ref.attrs.numpy()[same],
                               atol=1e-3)
    assert np.abs(depth[0].numpy()[same] - ref.depth.numpy()[same]).max() < 1e-2


def test_render_attrs_tiled_batched_frames_independent():
    v, f, a = scene(30, 10, 5, n_chan=3)
    v2 = v.copy()
    v2[:, 0] += 7.0
    attr, mask, _, _ = TR.render_attrs_tiled(
        t(np.stack([v, v2])), t(f), t(a), H, W, max_chunks=4)
    one, m1, _, _ = TR.render_attrs_tiled(t(v2)[None], t(f), t(a), H, W,
                                          max_chunks=4)
    assert not torch.equal(attr[0], attr[1])
    assert torch.equal(attr[1], one[0]) and torch.equal(mask[1], m1[0])


def test_render_attrs_tiled_overflow_and_errors():
    v, f, a = piled_scene()
    _, mask, _, ov = TR.render_attrs_tiled(t(v)[None], t(f), t(a), H, W,
                                           total_chunks=T)
    _, jmask, _, jov = PR.render_attrs_tiled(
        jnp.asarray(v)[None], jnp.asarray(f), jnp.asarray(a), H, W,
        total_chunks=T, interpret=True)
    assert int(ov) == int(jov) > 0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with pytest.raises(ValueError, match="multiple"):
        TR.render_attrs_tiled(t(v)[None], t(f), t(a), 60, 128)
    with pytest.raises(ValueError, match="total_chunks"):
        TR.render_attrs_tiled(t(v)[None], t(f), t(a), H, W,
                              total_chunks=T - 1)
    wide = np.zeros((1200, TR.MAX_ATTR + 1), np.float32)
    with pytest.raises(ValueError, match="attribute channels"):
        TR.render_attrs_tiled(t(v)[None], t(f), t(wide), H, W)


def test_wrapped_key_parity():
    """Few faces: float(depth_levels - 1) rounds up to 2^(31 - fb), so the
    far clip value shifts into the sign bit.  The port reproduces
    tpubody's wrapped key."""
    fb, dl = 6, 1 << 25
    table = np.zeros((1, T, TR.CF_FUSED, 6, 3), np.float32)
    table[..., 0:3, 2] = -1.0                      # sentinels everywhere
    table[0, 0, 0, 0:3, 2] = 1.0                   # one face covers tile 0
    table[0, 0, 0, 3, 2] = 2.0 ** 26               # beyond the far clip
    table[0, 0, 0, 4, 2] = 5.0                     # face id
    cstarts = np.arange(T + 1, dtype=np.int32)[None]
    win, _ = TR.fused_raster_reference(t(table), t(cstarts), H, W, fb, dl)
    jwin, _ = PR._fused_call(jnp.asarray(pallas_layout(table[0]))[None],
                             jnp.asarray(cstarts), H, W, 1, fb, dl, True)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    assert int(win[0, 0, 0]) == np.iinfo(np.int32).min + 5


@pytest.mark.parametrize("value", ["24", "4", "256", "sixteen"])
def test_cf_setting_is_validated_at_import(value):
    """TPUBODY_CF_FUSED must be a power of two in [8, 128]; anything else
    raises when the module is imported."""
    with pytest.raises(ValueError, match="power of two"):
        TR._parse_cf(value)
    env = dict(os.environ, TPUBODY_CF_FUSED=value)
    out = subprocess.run(
        [sys.executable, "-c", "import tpubody_torch.render.tiled_raster"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode != 0 and "power of two" in out.stderr


@pytest.mark.parametrize("value,want", [("8", 8), ("32", 32), ("128", 128)])
def test_cf_setting_accepts_powers_of_two(value, want):
    assert TR._parse_cf(value) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused_raster kernel has no CPU "
                    "mode; chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_faces,ext,C,maxc", [
    (4, 40, 12, 6, MAXC), (5, 30, 10, 3, MAXC), (6, 40, 12, 24, MAXC),
    (None, 400, 0, 3, T)])
def test_cuda_kernel_matches_plain(cuda, seed, n_faces, ext, C, maxc):
    from tpubody_torch import native

    v, f, a = piled_scene() if seed is None else scene(n_faces, ext, seed,
                                                       n_chan=C)
    vb = torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                         device=cuda)
    ab = torch.as_tensor(np.stack([a, a]), device=cuda)
    table, cstarts, _, _, meta = TR._bin_fused(
        vb, torch.as_tensor(f, device=cuda), ab, H, W, maxc, 2, 5)
    fb, dl = meta["fb"], meta["depth_levels"]
    before = native.LAUNCHES["fused_raster"]
    win, attr = TR.fused_raster(table, cstarts, H, W, fb, dl)
    torch.cuda.synchronize()
    assert native.LAUNCHES["fused_raster"] == before + 1
    win_p, attr_p = TR.fused_raster_reference(table, cstarts, H, W, fb, dl)
    assert torch.equal(win, win_p)            # same order of roundings
    assert (attr - attr_p).abs().max().item() <= 1e-6 * attr_p.abs().max().item()
    with pytest.raises(ValueError, match="dtype"):
        TR.fused_raster(table.double(), cstarts, H, W, fb, dl)
    with pytest.raises(ValueError, match="contiguous"):
        TR.fused_raster(table.transpose(0, 1).contiguous().transpose(0, 1),
                        cstarts, H, W, fb, dl)
