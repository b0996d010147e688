"""The z-buffer half of tpubody_torch.render.tiled_raster (bin_faces,
zbuffer_reference, zbuffer_tiled, rasterize_tiled) against
tpubody.render.pallas_raster, whose Pallas kernel ``_raster_kernel`` runs
in interpret mode on the CPU, on the 64x128 scenes of
tests/test_pallas_raster.py.

Tolerances (those of tests/test_torch_tiled_raster.py):
  * binning: chunk counts and overflow equal; the coefficient table, in
    tpubody's own layout, within a relative 1e-6 (both sides evaluate the
    same float32 expressions);
  * the plain version of the kernel vs the Pallas kernel on the SAME table:
    coverage and winning face equal at every pixel; the quantized depth in
    the key within 16 steps of up to 2^26 (the Pallas kernel sums
    a*px + b*py + c as one dot product, the port as (a*px + b*py) + c);
  * rasterize_tiled vs tpubody's: mask and face ids equal, attributes,
    barycentrics and depth within 1e-5 (pass 2 is the same float32
    expressions on the same winner).
The CUDA kernel runs only on a GPU: its test skips here and runs on the
card with
``python -m pytest --noconftest -p no:cacheprovider -k cuda tests/test_torch_zbuffer.py``.
"""
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tpubody.render import pallas_raster as PR
from tpubody_torch import native
from tpubody_torch.render import raster as raster_lib
from tpubody_torch.render import tiled_raster as TR

from tests.test_torch_raster import scene
from tests.test_torch_tiled_raster import (REJECTION_SCENES,
                                           assert_keys_agree, piled_scene,
                                           rejection_pairs)

torch.set_num_threads(1)

H, W = 64, 128
T = (H // 8) * (W // 128)
TABLE_RTOL = 1e-6
SHADE_ATOL = 1e-5


def t(x):
    return torch.as_tensor(x)


def pallas_zbuffer(table, nchunks, fb, depth_levels):
    """tpubody's ``_raster_kernel`` in interpret mode on a given table."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, T_, NC = table.shape[:3]
    kernel = functools.partial(PR._raster_kernel, fb=fb,
                               depth_levels=depth_levels)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(B, T_),
        in_specs=[pl.BlockSpec((1, 1, NC, 5 * PR.CF, 4),
                               lambda b, t, n_ref: (b, t, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, 1, PR.LP),
                               lambda b, t, n_ref: (b, t, 0, 0)))
    zflat = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((B, T_, 1, PR.LP), jnp.int32),
        interpret=True)(jnp.asarray(nchunks), jnp.asarray(table))
    z = np.asarray(zflat).reshape(B, H // 8, W // 128, 8, 128)
    return z.transpose(0, 1, 3, 2, 4).reshape(B, H, W)


CASES = [(0, 40, 12, 3, False, True), (4, 40, 12, 2, True, True),
         (5, 30, 10, 1, False, False)]


@pytest.mark.parametrize("seed,n_faces,ext,nc,cull,asc", CASES)
def test_bin_faces_matches(seed, n_faces, ext, nc, cull, asc):
    v, f, _ = scene(n_faces, ext, seed)
    jtab, jn, jov = PR.bin_faces(jnp.asarray(v), jnp.asarray(f), H, W, nc, 2,
                                 5, cull, asc)
    tab, n, ov = TR.bin_faces(t(v)[None], t(f), H, W, nc, 2, 5, cull, asc)
    assert tuple(tab.shape) == (1, T, nc, 5 * TR.CF, 4)
    assert n.dtype == torch.int32 and tab.is_contiguous()
    np.testing.assert_array_equal(n[0].numpy(), np.asarray(jn))
    assert int(ov[0]) == int(jov)
    np.testing.assert_allclose(tab[0].numpy(), np.asarray(jtab),
                               rtol=TABLE_RTOL, atol=1e-9)


def test_bin_faces_overflow_drops_the_same_faces():
    """One chunk a tile for 400 piled faces: the sort is stable on both
    sides, so the same faces are kept and the same count is reported."""
    v, f, _ = piled_scene()
    jtab, jn, jov = PR.bin_faces(jnp.asarray(v), jnp.asarray(f), H, W, 1)
    tab, n, ov = TR.bin_faces(t(v)[None], t(f), H, W, 1)
    assert int(ov[0]) == int(jov) > 0
    np.testing.assert_array_equal(n[0].numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tab[0, :, :, 4 * TR.CF:, 2].numpy(),
                                  np.asarray(jtab)[:, :, 4 * TR.CF:, 2])
    np.testing.assert_allclose(tab[0].numpy(), np.asarray(jtab),
                               rtol=TABLE_RTOL, atol=1e-9)


def test_bin_faces_batched_equals_per_frame():
    v, f, _ = scene(30, 10, 5)
    v2 = v.copy()
    v2[:, 0] += 7.0
    both = TR.bin_faces(t(np.stack([v, v2])), t(f), H, W, 2)
    for i, vv in enumerate((v, v2)):
        one = TR.bin_faces(t(vv)[None], t(f), H, W, 2)
        for x, y in zip(both, one):
            assert torch.equal(x[i], y[0])


def test_sentinels_fail_and_empty_tiles_write_int32_max():
    """A table of sentinels only, with nchunks saying one chunk a tile:
    nothing is covered.  With nchunks = 0 the chunk is not read at all."""
    v, f, _ = scene(40, 12, 0)
    tab, n, _ = TR.bin_faces(t(v[:3] * 0 - 500.0)[None], t(f[:1]), H, W, 1)
    assert int(n.sum()) == 0 and (tab[..., :3 * TR.CF, 2] == -1).all()
    for nch in (torch.ones_like(n), n):
        z = TR.zbuffer_reference(tab, nch, H, W, 1, 1 << 30)
        assert (z == TR.INT32_MAX).all()


@pytest.mark.parametrize("seed,n_faces,ext,nc", [
    (4, 40, 12, 3), (5, 30, 10, 2), (6, 40, 12, 1), (None, 400, 0, 2),
    (None, 400, 0, 4)])
def test_reference_matches_pallas_kernel_on_same_table(seed, n_faces, ext,
                                                       nc):
    v, f, _ = piled_scene() if seed is None else scene(n_faces, ext, seed)
    fb = raster_lib._face_bits(f.shape[0])
    dl = 1 << (31 - fb)
    tab, n, _ = TR.bin_faces(t(v)[None], t(f), H, W, nc)
    z = TR.zbuffer_reference(tab, n, H, W, fb, dl)
    assert z.dtype == torch.int32 and tuple(z.shape) == (1, H, W)
    jz = pallas_zbuffer(tab.numpy(), n.numpy(), fb, dl)
    assert assert_keys_agree(z, jz, fb) > 100
    # CPU tensors take the plain version, and count no launch
    before = native.LAUNCHES["zbuffer"]
    assert torch.equal(TR.zbuffer(tab, n, H, W, fb, dl), z)
    assert native.LAUNCHES["zbuffer"] == before


def test_reference_tile_blocks_do_not_change_the_result(monkeypatch):
    v, f, _ = scene(40, 12, 0)
    tab, n, _ = TR.bin_faces(t(v)[None], t(f), H, W, 2)
    z = TR.zbuffer_reference(tab, n, H, W, 6, 1 << 25)
    monkeypatch.setattr(TR, "_REF_TILE_BLOCK", 3)
    assert torch.equal(TR.zbuffer_reference(tab, n, H, W, 6, 1 << 25), z)


@pytest.mark.parametrize("seed,n_faces,ext,batched,asc", [
    (0, 40, 12, False, True), (2, 30, 10, True, True),
    (5, 30, 10, False, False)])
def test_rasterize_tiled_matches_tpubody(seed, n_faces, ext, batched, asc):
    v, f, a = scene(n_faces, ext, seed, n_chan=5)
    if seed == 2:     # the offscreen and degenerate faces of the JAX test
        v[:9] = [[-500, -500, 1]] * 9
        v[9:12] = [[5.0, 5.0, 1.0]] * 3
    vv = np.stack([v, v + np.float32([3.0, 1.0, 0.0])]) if batched else v
    want = PR.rasterize_tiled(jnp.asarray(vv), jnp.asarray(f), jnp.asarray(a),
                              H, W, max_chunks=3, depth_ascending=asc,
                              interpret=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = TR.rasterize_tiled(t(vv), t(f), t(a), H, W, max_chunks=3,
                                 depth_ascending=asc)
    assert tuple(got.attrs.shape) == ((2,) if batched else ()) + (H, W, 5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.face_id.numpy(),
                                  np.asarray(want.face_id))
    assert got.mask.sum() > 300
    np.testing.assert_allclose(got.attrs.numpy(), np.asarray(want.attrs),
                               atol=SHADE_ATOL)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary),
                               atol=SHADE_ATOL)
    m = got.mask.numpy()
    np.testing.assert_allclose(got.depth.numpy()[m],
                               np.asarray(want.depth)[m], atol=SHADE_ATOL)
    if not batched and asc:
        # the port's own oracle: the fragment rasterizer
        ref = raster_lib.rasterize(t(v), t(f), t(a), H, W, window=ext + 8)
        assert torch.equal(ref.mask, got.mask)
        assert torch.equal(ref.face_id, got.face_id)


def test_rasterize_tiled_surfaces_overflow():
    """200 faces piled on one tile of capacity 128: a warning, or the
    count with return_overflow, equal to tpubody's."""
    v, f, a = piled_scene()
    v, f, a = v[:600], f[:200], a[:600]
    with pytest.warns(RuntimeWarning, match="overflowed"):
        TR.rasterize_tiled(t(v), t(f), t(a), H, W, max_chunks=1)
    out, ov = TR.rasterize_tiled(t(v), t(f), t(a), H, W, max_chunks=1,
                                 return_overflow=True)
    _, jov = PR.zbuffer_tiled(jnp.asarray(v)[None], jnp.asarray(f), H, W,
                              max_chunks=1, interpret=True)
    assert isinstance(ov, torch.Tensor) and int(ov) == int(jov) > 0
    assert torch.isfinite(out.attrs).all()
    with pytest.raises(ValueError, match="multiple"):
        TR.zbuffer_tiled(t(v)[None], t(f), 60, 128)
    with pytest.raises(ValueError, match="table has shape"):
        TR.zbuffer(torch.zeros(1, T, 1, 5 * TR.CF, 3),
                   torch.zeros(1, T, dtype=torch.int32), H, W, 8, 1 << 23)


def test_wrapped_key_parity():
    """Few faces: float(depth_levels - 1) rounds up to 2^(31 - fb), so the
    far clip value shifts into the sign bit.  The port reproduces
    tpubody's wrapped key."""
    fb, dl = 6, 1 << 25
    table = np.zeros((1, T, 1, 5 * TR.CF, 4), np.float32)
    table[..., :3 * TR.CF, 2] = -1.0               # sentinels everywhere
    table[0, 0, 0, [0, TR.CF, 2 * TR.CF], 2] = 1.0     # one face covers tile 0
    table[0, 0, 0, 3 * TR.CF, 2] = 2.0 ** 26       # beyond the far clip
    table[0, 0, 0, 4 * TR.CF, 2] = 5.0             # face id
    n = np.ones((1, T), np.int32)
    z = TR.zbuffer_reference(t(table), t(n), H, W, fb, dl)
    np.testing.assert_array_equal(z.numpy(), pallas_zbuffer(table, n, fb, dl))
    assert int(z[0, 0, 0]) == np.iinfo(np.int32).min + 5
    assert int(z[0, 8, 0]) == TR.INT32_MAX


ZB_SCENES = {**REJECTION_SCENES, "heavy": lambda: piled_scene(1200)}


@pytest.mark.parametrize("case", ["heavy", "slivers", "tile_borders"])
def test_warp_rejection_is_conservative(case):
    """On the dense z-buffer table (128-face chunks, sentinel tails): no
    (face, warp) pair that the kernel skips holds a pixel that passes the
    plain inside test; every sentinel slot is skipped."""
    v, f, _ = ZB_SCENES[case]()
    tab, n, _ = TR.bin_faces(t(v)[None], t(f), H, W, 10)
    edges = tab[0, ..., 0:3 * TR.CF, 0:3].reshape(T, -1, 3, TR.CF, 3) \
        .permute(0, 1, 3, 2, 4).reshape(-1, 3, 3)
    rejected, reached = rejection_pairs(edges)
    assert not (rejected & reached).any(), case
    sentinel = ((edges[:, :, 0] == 0) & (edges[:, :, 1] == 0)
                & (edges[:, :, 2] == -1)).all(dim=1)
    assert rejected[sentinel].all() and sentinel.any()
    assert rejected[~sentinel].float().mean() > 0.4


@pytest.mark.parametrize("case,ranks", [("heavy", 2), ("heavy", 1),
                                        ("slivers", 2)])
def test_emulated_kernel_equals_plain_bit_for_bit(case, ranks):
    """The kernel's algorithm, emulated in torch (``ranks`` blocks split a
    tile's chunks, warps skip the faces the rejection drops, block 0 takes
    the minimum of the blocks' keys): equal to the plain version bit for
    bit, on a tile of 10 chunks (more than the blocks) and on slivers."""
    v, f, _ = ZB_SCENES[case]()
    fb = raster_lib._face_bits(f.shape[0])
    dl = 1 << (31 - fb)
    vb = t(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]))
    tab, n, ov = TR.bin_faces(vb, t(f), H, W, 10)
    assert int(ov.sum()) == 0
    if case == "heavy":
        assert int(n.max()) == 10 > ranks
    want = TR.zbuffer_reference(tab, n, H, W, fb, dl)
    got = TR.zbuffer_emulated(tab, n, H, W, fb, dl, ranks)
    assert torch.equal(got, want)
    assert int((want != TR.INT32_MAX).sum()) > 100


def test_emulated_kernel_keeps_the_wrapped_key():
    """The wrapped-key toy table through the emulated kernel (a face whose
    edges are the constant 1 is kept by every warp)."""
    fb, dl = 6, 1 << 25
    table = np.zeros((1, T, 1, 5 * TR.CF, 4), np.float32)
    table[..., :3 * TR.CF, 2] = -1.0
    table[0, 0, 0, [0, TR.CF, 2 * TR.CF], 2] = 1.0
    table[0, 0, 0, 3 * TR.CF, 2] = 2.0 ** 26
    table[0, 0, 0, 4 * TR.CF, 2] = 5.0
    n = np.ones((1, T), np.int32)
    for ranks in (1, 2):
        z = TR.zbuffer_emulated(t(table), t(n), H, W, fb, dl, ranks)
        assert torch.equal(z, TR.zbuffer_reference(t(table), t(n), H, W, fb,
                                                   dl))
    assert int(z[0, 0, 0]) == np.iinfo(np.int32).min + 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the zbuffer kernel has no CPU mode; "
                    "chip_smoke.py runs this comparison on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["heavy", "slivers", "tile_borders"])
@pytest.mark.parametrize("cluster", [1, 2])
def test_cuda_kernel_heavy_tile_and_slivers(cuda, case, cluster):
    """A tile of 10 chunks (more than the blocks of a cluster), slivers and
    border-aligned faces, at each cluster size: equal to the plain version
    at every pixel."""
    v, f, _ = ZB_SCENES[case]()
    fb = raster_lib._face_bits(f.shape[0])
    dl = 1 << (31 - fb)
    vb = torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                         device=cuda)
    tab, n, _ = TR.bin_faces(vb, torch.as_tensor(f, device=cuda), H, W, 10)
    before = native.LAUNCHES["zbuffer"]
    z = TR._zbuffer_launch(tab, n, H, W, fb, dl, cluster)
    torch.cuda.synchronize()
    assert native.LAUNCHES["zbuffer"] == before + 1
    assert torch.equal(z, TR.zbuffer_reference(tab, n, H, W, fb, dl))
    assert int((z != TR.INT32_MAX).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_faces,ext,nc", [
    (0, 40, 12, 3), (4, 40, 12, 2), (None, 400, 0, 2), (None, 400, 0, 4)])
def test_cuda_kernel_matches_plain(cuda, seed, n_faces, ext, nc):
    v, f, _ = piled_scene() if seed is None else scene(n_faces, ext, seed)
    fb = raster_lib._face_bits(f.shape[0])
    dl = 1 << (31 - fb)
    vb = torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                         device=cuda)
    tab, n, _ = TR.bin_faces(vb, torch.as_tensor(f, device=cuda), H, W, nc)
    before = native.LAUNCHES["zbuffer"]
    z = TR.zbuffer(tab, n, H, W, fb, dl)
    torch.cuda.synchronize()
    assert native.LAUNCHES["zbuffer"] == before + 1
    assert torch.equal(z, TR.zbuffer_reference(tab, n, H, W, fb, dl))
    assert int((z != TR.INT32_MAX).sum()) > 100
    with pytest.raises(ValueError, match="dtype"):
        TR.zbuffer(tab.double(), n, H, W, fb, dl)
    with pytest.raises(ValueError, match="contiguous"):
        TR.zbuffer(tab.transpose(0, 1).contiguous().transpose(0, 1), n, H, W,
                   fb, dl)
