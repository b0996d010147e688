"""HMRSMPLStep's pipelined copy in: a host batch of at least two chunks of
``serving.CHUNK_FRAMES`` on a CUDA step is copied chunk by chunk on a side
stream while the card runs the backbone on the chunk before; the head and
the LBS run once on the whole batch.

On the CPU: which inputs take which path, ``head(backbone(x)) ==
model(x)`` for the three models, the chunked backbone under one head equal
to the one-shot forward (driven through the private helper with an
explicit chunk size), and its spans (one ``step.h2d`` and one backbone a
chunk).  On the card: the three models of the benchmark's cells, on their
seeded weights, at the cells' 512 frames and at a ragged batch of three
chunks, pipelined against the same chunks run from the card's memory and
against the one-shot path on the same images, with the launches of
each.  No JAX: the
card test runs on the card as it is.
"""
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from tpubody_torch import native
from tpubody_torch.models import hmr as thmr
from tpubody_torch.models import hmr2
from tpubody_torch.models import hmr_quant as tq
from tpubody_torch.pipelines import serving
from tpubody_torch.utils import profiling

torch.set_num_threads(2)

CHUNK = serving.CHUNK_FRAMES
RAGGED = 2 * CHUNK + CHUNK // 3      # three chunks, the last ragged
SIZE = 32
REL = 1e-5
TINY_HMR2 = dict(image_size=SIZE, crop_width=24, patch_size=8, dim=16,
                 depth=2, heads=2, mlp_dim=32, dec_dim=16, dec_depth=1,
                 dec_heads=2, dec_dim_head=8, dec_mlp_dim=16)


def _step(device):
    """A step with no model: the engagement rule reads only the device."""
    return serving.HMRSMPLStep(None, None, torch.device(device), SIZE)


@pytest.mark.parametrize("device, make, frames, chunks", [
    ("cuda", np.zeros, 4 * CHUNK, 4),
    ("cuda", np.zeros, RAGGED, 3),               # the last chunk ragged
    ("cuda", np.zeros, 2 * CHUNK, 2),
    ("cuda", np.zeros, 2 * CHUNK - 1, 1),        # under two chunks
    ("cuda", np.zeros, 64, 1),
    ("cuda", torch.zeros, 4 * CHUNK, 4),         # a CPU tensor is host
    ("cuda", functools.partial(torch.zeros, device="meta"), 4 * CHUNK, 1),
    ("cpu", np.zeros, 4 * CHUNK, 1),             # every CPU step
    ("cpu", torch.zeros, 4 * CHUNK, 1),
])
def test_engagement_rule(device, make, frames, chunks):
    """Chunks only on CUDA, for images in host memory (numpy or a CPU
    tensor), of at least two chunks; a tensor elsewhere ("meta" stands in
    for the card's memory here) and a CPU step copy in one piece."""
    images = make((frames, 1, 1, 3))
    assert _step(device)._chunks(images) == chunks


@pytest.fixture(scope="module")
def models():
    """The three models, small, in float32 on the CPU."""
    hmr = thmr.create_hmr(dtype=torch.float32, device="cpu",
                          stage_sizes=(1, 1, 1, 1))
    calib = np.random.default_rng(0).normal(
        scale=0.5, size=(4, SIZE, SIZE, 3)).astype(np.float32)
    int8 = tq.QuantizedHMR(tq.quantize_hmr(
        thmr.create_hmr(dtype=torch.float32, device="cpu"), calib))
    vit = hmr2.create_hmr2(dtype=torch.float32, device="cpu", **TINY_HMR2)
    return {"hmr": hmr, "int8": int8, "hmr2": vit}


def _images(n, seed=22):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2"))
def test_head_of_backbone_is_the_model(models, name):
    model = models[name]
    x = torch.as_tensor(_images(3))
    with torch.inference_mode():
        assert _equal(model.head(model.backbone(x)), model(x))


@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2"))
@pytest.mark.parametrize("frames, chunk", ((5, 2), (6, 3)))
def test_chunked_backbone_under_one_head_is_the_forward(models, name,
                                                        frames, chunk):
    """Every backbone works frame by frame: in chunks of ``chunk`` frames
    (the last ragged where ``frames`` is not a multiple), with the head
    once on the joined features, the answers equal the one-shot forward's
    on the CPU: int8 bit for bit (integer sums, per-element epilogues),
    float32 within REL of each output's largest magnitude (the CPU's
    convolutions sum in another order at another batch: 3.6e-6 read at a
    one-frame chunk)."""
    model = models[name]
    step = serving.HMRSMPLStep(model, None, torch.device("cpu"), SIZE)
    x = _images(frames)
    with torch.inference_mode():
        got = model.head(step._backbone_in_chunks(x, chunk))
        want = model(torch.as_tensor(x))
    if name == "int8":
        assert _equal(got, want)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) < REL


def test_chunked_spans(models):
    """Under a profiler session the helper records one ``step.h2d`` and
    one backbone span a chunk, in turn."""
    step = serving.HMRSMPLStep(models["hmr"], None, torch.device("cpu"),
                               SIZE)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]), \
                torch.inference_mode(), profiling.span("step"):
            step._backbone_in_chunks(_images(5), 2)
        records = profiling.spans()
    finally:
        profiling.clear()
    root = records[0]
    names = [r["name"] for r in records if r["parent"] == root["id"]]
    assert names == ["step.h2d", "hmr.backbone"] * 3


# -- on the card ----------------------------------------------------------
CELLS = {"hmr": "hmr_bf16.offline_b512", "int8": "hmr_int8.offline_b512",
         "hmr2": "hmr2_bf16.offline_b512"}
# Launches of one backbone call of each kernel a model's backbone runs.
BACKBONE_LAUNCHES = {"hmr": {}, "int8": {"int8_requant": 53},
                     "hmr2": {"add_layernorm": 64}}
SEED = 2 ** 32 + 22
# HMR 2.0's step against itself on the same chunks: five times the
# largest difference between two runs of one step read on the card (2e-4,
# vertices and camera).
RUN_TO_RUN = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipelined copy in runs on "
                    "CUDA steps only")
    return torch.device("cuda")


def _composed(step, images):
    """The step's backbone on the same chunks of ``images`` already on the
    card, then its head and LBS once, all on one stream."""
    from tpubody_torch.models import smpl

    with torch.inference_mode():
        features = torch.cat([step.hmr.backbone(images[a:a + CHUNK])
                              for a in range(0, len(images), CHUNK)])
        out = step.hmr.head(features)
        verts = smpl.forward_batch_verts(step.body, out.rotmats, out.shape,
                                         None, pose_is_rotmat=True)
    return verts, out.cam


def _step_launches(step, images, chunks, name):
    """The step on ``images`` -> its outputs, having held its launches:
    ``fused_lbs`` once, the backbone's kernels once a chunk."""
    native.reset_launches()
    out = step(images)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    assert launches["fused_lbs"] == 1, launches
    for kernel, count in BACKBONE_LAUNCHES[name].items():
        assert launches[kernel] == count * chunks, launches
    return out


def _within_limits(got, want, cfg, device):
    """``got`` within the cell's limits of ``correct``
    (``benchmark/compare.py``), ``want`` as the reference."""
    from benchmark import compare

    correct, _ = compare.check(
        [(0, 0, tuple(t.cpu().numpy() for t in got))],
        [tuple(t.cpu().numpy() for t in want)], cfg["limits"], device)
    return correct


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2"))
def test_cuda_pipelined_step_against_one_shot(cuda, name):
    """The cell's step on its seeded weights, at 512 frames and at a
    ragged RAGGED, from host numpy (pipelined), against the same chunks'
    backbones run from the card's memory on one stream (so the side
    stream's copies are all in place before each chunk is read): HMR's
    bit-equal; HMR 2.0's within RUN_TO_RUN of each output (its step on
    the card differs from itself run to run, by 2e-4 read).  And against
    the one-shot step on the same images on the card: int8 bit-equal;
    bf16, whose convolutions and products may sum in another order at
    another batch, within the cell's limits."""
    cfg, config = harness.config_of(harness.cell_of(
        harness.benchmark_spec(), CELLS[name])["config"])
    step = config.build(cfg, config.make_inputs(cfg, SEED, cuda), cuda)
    size = cfg["image_size"]
    for frames in (512, RAGGED):
        host = np.random.default_rng(frames).normal(
            scale=0.5, size=(frames, size, size, 3)).astype(np.float32)
        chunks = -(-frames // CHUNK)
        assert step._chunks(host) == chunks > 1
        got = _step_launches(step, host, chunks, name)
        images = torch.as_tensor(host, device=cuda)
        composed = _composed(step, images)
        if name == "hmr2":
            for a, b in zip(got, composed):
                assert float((a - b).abs().max()) <= RUN_TO_RUN, frames
        else:
            assert _equal(got, composed), frames
        want = _step_launches(step, images, 1, name)
        if name == "int8":
            assert _equal(got, want), frames
        else:
            assert _within_limits(got, want, cfg, cuda), frames
        del got, want, composed, images
    del step
    torch.cuda.empty_cache()
