"""tpubody_torch.utils.profiling: the program's spans, on only while a
torch.profiler session records.

The serving step (bf16 and int8 at 32^2, 300 vertices, on the CPU) and the
fused LBS path record their layers with parent and root ids; the outputs
do not change under the profiler; the chrome trace holds each span; the
store keeps the newest roots and nests per thread; StageTimer's stages are
spans.  One test pins the private profiler flag the spans read.
"""
import json
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tpubody_torch.core import fused_lbs
from tpubody_torch.models import params as tparams
from tpubody_torch.pipelines import serving
from tpubody_torch.utils import profiling

torch.set_num_threads(1)

SIZE = 32
# The int8 backbone's convolutions at (3, 4, 6, 3): the stem, three a
# bottleneck and four downsamples.
N_CONVS = 1 + 3 * 16 + 4
# Its epilogue spans: one requantize a convolution (the residual adds
# inside conv3's), the max-pool, the mean.
N_EPILOGUES = N_CONVS + 1 + 1


@pytest.fixture(scope="module")
def steps():
    return {"bf16": serving.hmr_smpl_step(dtype=torch.bfloat16,
                                          image_size=SIZE, n_verts=300,
                                          device="cpu"),
            "int8": serving.hmr_smpl_step(quantize=True, image_size=SIZE,
                                          n_verts=300, device="cpu")}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(16).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def children(records, parent):
    return [r["name"] for r in records if r["parent"] == parent["id"]]


def test_profiler_flag_is_pinned():
    """The spans read torch.autograd.profiler._is_profiler_enabled: set
    while a session records, clear before and after.  A torch that renames
    it fails here."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag() is True
    assert flag() is False


@pytest.mark.parametrize("kind", ("bf16", "int8"))
def test_no_profiler_records_nothing(steps, images, kind):
    steps[kind](images)
    assert profiling.span("x") is profiling.span("y")
    assert profiling.spans() == []


@pytest.mark.parametrize("kind", ("bf16", "int8"))
def test_outputs_equal_with_and_without_profiler(steps, images, kind):
    plain = steps[kind](images)
    traced, records = recorded(lambda: steps[kind](images))
    assert records
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_bf16_step_records_its_layers(steps, images):
    _, records = recorded(lambda: steps["bf16"](images))
    root = records[0]
    assert root["name"] == "step" and root["parent"] is None
    assert root["root"] == root["id"]
    assert children(records, root) == ["step.h2d", "hmr.backbone", "hmr.ief"]
    assert all(r["root"] == root["id"] for r in records)
    assert Counter(r["name"] for r in records) == {
        "step": 1, "step.h2d": 1, "hmr.backbone": 1, "hmr.ief": 1}


def test_int8_step_records_the_split(steps, images):
    _, records = recorded(lambda: steps["int8"](images))
    root = records[0]
    assert root["name"] == "step" and root["parent"] is None
    assert children(records, root) == ["step.h2d", "hmr_quant.backbone",
                                       "hmr.ief"]
    backbone = next(r for r in records if r["name"] == "hmr_quant.backbone")
    counts = Counter(children(records, backbone))
    assert counts == {"hmr_quant.quantize": N_CONVS,
                      "hmr_quant.products": N_CONVS,
                      "hmr_quant.epilogue": N_EPILOGUES}
    assert all(r["root"] == root["id"] for r in records)
    # The split tiles the backbone: on the CPU the times are the host's.
    split = sum(r["device_ms"] for r in records
                if r["parent"] == backbone["id"])
    assert 0 < split <= backbone["device_ms"]
    for r in records:
        assert r["device_ms"] == pytest.approx(r["end_ms"] - r["start_ms"])
        assert 0 <= r["start_ms"] <= r["end_ms"] <= root["end_ms"]


def test_fused_lbs_records_prologue_and_kernel():
    body = tparams.load_or_synthetic("smpl", n_joints=24, n_verts=300,
                                     seed=0, warn=False, device="cpu")
    rots = torch.eye(3).expand(3, 24, 3, 3).contiguous()
    beta = torch.zeros(3, body.shapedirs.shape[-1])

    def run():
        return fused_lbs.lbs_forward_batch_fused(
            body.v_template, body.shapedirs, body.posedirs,
            body.j_regressor, body.weights, body.parents, rots, beta,
            pose_is_rotmat=True, kernel_precision="bf16x3",
            layouts=fused_lbs.model_layouts(body))

    plain = run()
    traced, records = recorded(run)
    assert torch.equal(plain, traced)
    assert [(r["name"], r["parent"]) for r in records] == [
        ("lbs.prologue", None), ("fused_lbs", None)]


def test_chrome_trace_holds_each_span(steps, images, tmp_path):
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps["int8"](images)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotations = Counter(e["name"] for e in events
                          if e.get("cat") == "user_annotation")
    assert annotations == Counter(r["name"] for r in profiling.spans())


def test_warmup_of_a_schedule_records_nothing(steps, images):
    """A scheduled session records only its active steps (the benchmark
    warms the profiler up on one batch, then profiles the next)."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for _ in range(3):
            steps["bf16"](images)
            prof.step()
    roots = [r for r in profiling.spans() if r["parent"] is None]
    assert [r["name"] for r in roots] == ["step", "step"]


def test_store_keeps_the_newest_roots():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.MAX_ROOTS + 5):
            with profiling.span(f"r{i}"):
                with profiling.span("child"):
                    pass
    records = profiling.spans()
    roots = [r["name"] for r in records if r["parent"] is None]
    assert roots == [f"r{i}" for i in range(5, profiling.MAX_ROOTS + 5)]
    assert len(records) == 2 * profiling.MAX_ROOTS
    profiling.clear()
    assert profiling.spans() == []


def test_threads_nest_their_own_spans():
    """Two threads, each inside its own root, interleaved by barriers:
    each child's parent is its own thread's root."""
    barrier = threading.Barrier(2, timeout=30)

    def work(name):
        with profiling.span(name):
            barrier.wait()
            with profiling.span(name + ".child"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_id = {r["id"]: r for r in profiling.spans()}
    for r in by_id.values():
        if r["parent"] is not None:
            assert by_id[r["parent"]]["name"] + ".child" == r["name"]
            assert r["root"] == r["parent"]


def test_stage_timer_stages_are_spans():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("outer"):
            with timer.stage("inner"):
                pass
    assert [r["stage"] for r in timer.records] == ["inner", "outer"]
    records = profiling.spans()
    assert [(r["name"], r["parent"]) for r in records] == [
        ("outer", None), ("inner", records[0]["id"])]
    with timer.stage("untraced"):
        pass
    assert len(profiling.spans()) == 2
    assert "untraced" in timer.report()


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", (False, True))
def test_cuda_spans_time_the_device(quantize, tmp_path):
    """On the card the spans' device times come from their CUDA events:
    every child lies inside its root's device interval, the int8 split
    inside its backbone's (at this size the host sets the pace, so the
    card also waits between the split's spans; at the cells' size they
    tile it, ``benchmark/tests/test_bench_program_spans.py``), and each
    span that launches work itself is also a device range in the chrome
    trace (the profiler gives a kernel's range to its innermost span only,
    so ``step`` has none there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    step = serving.hmr_smpl_step(quantize=quantize, image_size=64,
                                 n_verts=6890, device="cuda")
    images = np.random.default_rng(1).normal(
        size=(32, 64, 64, 3)).astype(np.float32)
    plain = step(images)
    path = tmp_path / "trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = step(images)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    records = profiling.spans()
    root = records[0]
    assert root["name"] == "step" and root["device_ms"] > 0
    assert {"lbs.prologue", "fused_lbs"} <= set(children(records, root))
    for r in records:
        assert -1e-3 <= r["start_ms"] <= r["end_ms"] <= root["end_ms"] + 1e-3
    if quantize:
        backbone = next(r for r in records
                        if r["name"] == "hmr_quant.backbone")
        split = [r for r in records if r["parent"] == backbone["id"]]
        assert len(split) == 3 * N_CONVS + (N_EPILOGUES - N_CONVS)
        for r in split:
            assert (backbone["start_ms"] - 1e-3 <= r["start_ms"]
                    <= r["end_ms"] <= backbone["end_ms"] + 1e-3)
        assert 0 < sum(r["device_ms"] for r in split) <= (
            backbone["device_ms"] + 1e-3)
    events = json.loads(path.read_text())["traceEvents"]
    device = {e["name"] for e in events
              if e.get("cat") == "gpu_user_annotation"}
    assert {"step.h2d", "hmr.ief", "lbs.prologue", "fused_lbs"} <= device
