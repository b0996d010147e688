"""HMRSMPLStep's pipelined copy in: a host batch of at least two chunks on
a CUDA step is copied chunk by chunk on a side stream while the card runs
the backbone on the chunk before; the head and the LBS run once on the
whole batch.  A chunk is sized by a frame's bytes
(``serving.chunk_frames``): 256 frames at 224^2 and 256^2, 16 at 896^2.

On the CPU: which inputs take which path, at the cells' frame shapes too,
and the chunk the step hands on; ``head(backbone(x)) == model(x)`` for the
four models, the chunked backbone under one head equal to the one-shot
forward (driven through the private helper with an explicit chunk size),
and its spans (one ``step.h2d`` and one backbone a chunk).  On the card:
the four models of the benchmark's cells, on their seeded weights, at the
cells' batches and at a ragged batch of three chunks, pipelined against
the same chunks run from the card's memory and against the one-shot path
on the same images, with the launches of each.  No JAX: the card test
runs on the card as it is.
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
from tpubody_torch.models import multihmr
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
TINY_MULTIHMR = dict(image_size=SIZE, patch_size=8, dim=16, depth=2,
                     heads=2, mlp_dim=32, pos_grid=3, head_dim=16,
                     head_depth=1, head_heads=2, head_dim_head=8,
                     head_mlp_dim=16, centres=(5, 10))


def _step(device):
    """A step with no model: the engagement rule reads only the device and
    the images' shape."""
    return serving.HMRSMPLStep(None, None, torch.device(device), SIZE)


def _frames(side):
    """-> make(shape): shape[0] zero frames of ``side``^2 in host numpy, a
    broadcast view that holds no frame's memory."""
    return lambda shape: np.broadcast_to(np.float32(0),
                                         (shape[0], side, side, 3))


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
    # The cells' frames: 224^2 and 256^2 in 2 chunks of 256, 896^2 in 16s.
    pytest.param("cuda", _frames(224), 512, 2, id="cuda-224sq-512-2"),
    pytest.param("cuda", _frames(256), 512, 2, id="cuda-256sq-512-2"),
    pytest.param("cuda", _frames(896), 64, 4, id="cuda-896sq-64-4"),
    pytest.param("cuda", _frames(896), 37, 3, id="cuda-896sq-37-3"),
    pytest.param("cuda", _frames(896), 31, 1, id="cuda-896sq-31-1"),
])
def test_engagement_rule(device, make, frames, chunks):
    """Chunks only on CUDA, for images in host memory (numpy or a CPU
    tensor), of at least two chunks of the frame's ``chunk_frames``; a
    tensor elsewhere ("meta" stands in for the card's memory here) and a
    CPU step copy in one piece."""
    images = make((frames, 1, 1, 3))
    assert _step(device)._chunks(images) == chunks


class _Handed(Exception):
    """Raised by the stand-in for the chunked backbone once it has seen
    its chunk."""


@pytest.mark.parametrize("side, frames, chunk",
                         ((224, 512, 256), (256, 512, 256), (896, 64, 16)))
def test_step_hands_on_the_rules_chunk(monkeypatch, side, frames, chunk):
    """The step passes ``_backbone_in_chunks`` the chunk the rule gives the
    cells' frames: 256 at 224^2 and 256^2, 16 at 896^2."""
    seen = []

    def backbone_in_chunks(images, n):
        seen.append(n)
        raise _Handed

    step = _step("cuda")
    monkeypatch.setattr(step, "_backbone_in_chunks", backbone_in_chunks)
    with pytest.raises(_Handed):
        step(_frames(side)((frames,)))
    assert seen == [chunk] == [serving.chunk_frames((side, side, 3))]


@pytest.fixture(scope="module")
def models():
    """The four models, small, in float32 on the CPU."""
    hmr = thmr.create_hmr(dtype=torch.float32, device="cpu",
                          stage_sizes=(1, 1, 1, 1))
    calib = np.random.default_rng(0).normal(
        scale=0.5, size=(4, SIZE, SIZE, 3)).astype(np.float32)
    int8 = tq.QuantizedHMR(tq.quantize_hmr(
        thmr.create_hmr(dtype=torch.float32, device="cpu"), calib))
    vit = hmr2.create_hmr2(dtype=torch.float32, device="cpu", **TINY_HMR2)
    dino = multihmr.create_multihmr(dtype=torch.float32, device="cpu",
                                    **TINY_MULTIHMR)
    return {"hmr": hmr, "int8": int8, "hmr2": vit, "multihmr": dino}


def _images(n, seed=22):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2", "multihmr"))
def test_head_of_backbone_is_the_model(models, name):
    model = models[name]
    x = torch.as_tensor(_images(3))
    with torch.inference_mode():
        assert _equal(model.head(model.backbone(x)), model(x))


@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2", "multihmr"))
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
    one backbone span a chunk, in turn: HMR's and Multi-HMR's."""
    for name, backbone in (("hmr", "hmr.backbone"),
                           ("multihmr", "multihmr.backbone")):
        step = serving.HMRSMPLStep(models[name], None, torch.device("cpu"),
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
        assert names == ["step.h2d", backbone] * 3, name


# -- on the card ----------------------------------------------------------
CELLS = {"hmr": "hmr_bf16.offline_b512", "int8": "hmr_int8.offline_b512",
         "hmr2": "hmr2_bf16.offline_b512",
         "multihmr": "multihmr_bf16.offline_b64"}
# Launches of one backbone call of each kernel a model's backbone runs.
BACKBONE_LAUNCHES = {"hmr": {}, "int8": {"int8_requant": 53},
                     "hmr2": {"add_layernorm": 64},
                     "multihmr": {"add_layernorm": 48}}
SEED = 2 ** 32 + 22
# A transformer's step against itself on the same chunks: five times the
# largest difference between two runs of one step read on the card (HMR
# 2.0 2e-4, vertices and camera; Multi-HMR 1.3e-4, vertices and
# translations).
RUN_TO_RUN = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipelined copy in runs on "
                    "CUDA steps only")
    return torch.device("cuda")


def _composed(step, images, chunk):
    """The step's backbone on the same chunks of ``chunk`` frames of
    ``images`` already on the card, then its head and LBS once, all on one
    stream, shaped as the step answers."""
    from tpubody_torch.models import smpl

    with torch.inference_mode():
        features = torch.cat([step.hmr.backbone(images[a:a + chunk])
                              for a in range(0, len(images), chunk)])
        out = step.hmr.head(features)
        persons = getattr(step.hmr, "persons", None)
        if persons is None:
            verts = smpl.forward_batch_verts(step.body, out.rotmats,
                                             out.shape, None,
                                             pose_is_rotmat=True)
            return verts, out.cam
        verts, transl = smpl.forward_batch_placed(
            step.body, out.rotmats, out.shape, step.hmr.anchor_joint,
            out.cam)
    return (verts.view(-1, persons, *verts.shape[1:]),
            transl.view(-1, persons, 3))


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
@pytest.mark.parametrize("name", ("hmr", "int8", "hmr2", "multihmr"))
def test_cuda_pipelined_step_against_one_shot(cuda, name):
    """The cell's step on its seeded weights, at the cell's batch (512
    frames; Multi-HMR's 64 of 896^2, 4 chunks of 16) and at a ragged three
    chunks, from host numpy (pipelined), against the same chunks'
    backbones run from the card's memory on one stream (so the side
    stream's copies are all in place before each chunk is read): HMR's
    bit-equal; the transformers' within RUN_TO_RUN of each output (their
    steps on the card differ from themselves run to run).
    And against the one-shot step on the same images on the card: int8
    bit-equal; bf16, whose convolutions and products may sum in another
    order at another batch, within the cell's limits."""
    cell = harness.cell_of(harness.benchmark_spec(), CELLS[name])
    cfg, config = harness.config_of(cell["config"])
    step = config.build(cfg, config.make_inputs(cfg, SEED, cuda), cuda)
    size = cfg["image_size"]
    chunk = serving.chunk_frames((size, size, 3))
    for frames in (harness.mix_of(cell["traffic"])["batch"],
                   2 * chunk + chunk // 3):
        host = np.random.default_rng(frames).normal(
            scale=0.5, size=(frames, size, size, 3)).astype(np.float32)
        chunks = -(-frames // chunk)
        assert step._chunks(host) == chunks > 1
        got = _step_launches(step, host, chunks, name)
        images = torch.as_tensor(host, device=cuda)
        composed = _composed(step, images, chunk)
        if name in ("hmr2", "multihmr"):
            for a, b in zip(got, composed):
                diff = float((a - b).abs().max())
                assert diff <= RUN_TO_RUN, (frames, diff)
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
