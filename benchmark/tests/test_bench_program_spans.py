"""The metrics that read the program's own spans (``benchmark/
program_spans.py``): a tiny traced run of each cell on the CPU reports each
of them, a program without spans reads nothing and does not raise, and the
step's self time is what no child span covers.

On the CPU ``HMRSMPLStep`` skins with ``smpl.forward_batch``; the card's
route goes through ``fused_lbs.lbs_forward_batch_fused``, whose plain
version runs on the CPU, so the tiny runs take that route to record the
LBS spans as the card does."""
import sys
import time
import types

import pytest
import torch

from benchmark import harness, program_spans

CELLS = ("hmr_bf16.offline_b512", "hmr_int8.offline_b512")
SEED = 2 ** 32 + 16
TINY = {"mix": {"batch": 2, "span_batches": 1, "profiled_batches": 2,
                "checked_batches": 1},
        "config": {"image_size": 64, "stage_sizes": [1, 1, 1, 1]}}


def span_metrics(workload):
    return [m["name"] for m in harness.metrics_of(harness.benchmark_spec(),
                                                  workload, True)
            if m["source"] == "program_span" and
            m["name"].endswith(".span_ms")]


@pytest.fixture
def fused_route(monkeypatch):
    """``forward_batch_verts`` through the fused LBS path, as on the card."""
    from tpubody_torch.core import fused_lbs
    from tpubody_torch.models import smpl

    def verts(model, poses, beta, trans=None, use_kernel=None,
              pose_is_rotmat=False, kernel_precision="bf16x3"):
        return fused_lbs.lbs_forward_batch_fused(
            model.v_template, model.shapedirs, model.posedirs,
            model.j_regressor, model.weights, model.parents, poses, beta,
            trans, pose_is_rotmat=pose_is_rotmat,
            kernel_precision=kernel_precision,
            layouts=fused_lbs.model_layouts(model))

    monkeypatch.setattr(smpl, "forward_batch_verts", verts)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_each_span_metric(workload, fused_route):
    names = span_metrics(workload)
    assert len(names) == {CELLS[0]: 5, CELLS[1]: 8}[workload]
    result = harness.run_cell(workload, SEED, 0.3, True, time.perf_counter(),
                              torch.device("cpu"), overrides=TINY)
    for name in names:
        assert result["metrics"][name]["value"] is not None, name
        assert result["metrics"][name]["value"] >= 0, name
    if workload == CELLS[1]:
        m = {k: v["value"] for k, v in result["metrics"].items()}
        split = sum(m[f"hmr_quant.{p}.span_ms"]
                    for p in ("quantize", "products", "epilogue"))
        assert 0 < split <= m["hmr_quant.backbone.span_ms"] * 1.001


def test_untraced_run_records_no_spans():
    from tpubody_torch.utils import profiling

    profiling.clear()
    harness.run_cell(CELLS[0], SEED, 0.2, False, time.perf_counter(),
                     torch.device("cpu"), overrides=TINY)
    assert profiling.spans() == []


def _run(profiled=2):
    return types.SimpleNamespace(mix={"profiled_batches": profiled})


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.ModuleType(program_spans.MODULE))
    assert program_spans.roots(_run()) == []
    assert program_spans.span_ms(_run(), "step.h2d") is None
    assert program_spans.self_ms(_run()) is None
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert program_spans.span_ms(_run(), "step.h2d") is None


def _rec(name, id_, parent, root, start, end):
    return {"name": name, "id": id_, "parent": parent, "root": root,
            "host_ms": end - start, "device_ms": end - start,
            "start_ms": start, "end_ms": end}


def test_span_sums_and_self_time(monkeypatch):
    """Three roots, the newest two read: sums within a root, medians over
    roots; the self time is the step's interval minus its children's union
    (overlaps counted once, grandchildren not again)."""
    records = [_rec("step", 0, None, 0, 0, 100),
               _rec("hmr.ief", 1, 0, 0, 0, 100),
               _rec("other", 9, None, 9, 0, 5)]
    for base, gap in ((10, 4.0), (20, 6.0)):
        records += [_rec("step", base, None, base, 0, 50),
                    _rec("step.h2d", base + 1, base, base, 0, 20),
                    _rec("hmr.ief", base + 2, base, base, 15, 30),
                    _rec("x", base + 3, base + 2, base, 16, 18),
                    _rec("hmr.ief", base + 4, base, base, 30 + gap, 50)]
    module = types.ModuleType(program_spans.MODULE)
    module.spans = lambda: records
    monkeypatch.setitem(sys.modules, program_spans.MODULE, module)
    assert [g[0]["id"] for g in program_spans.roots(_run())] == [10, 20]
    assert program_spans.span_ms(_run(), "step.h2d") == 20
    assert program_spans.span_ms(_run(), "hmr.ief") == pytest.approx(
                                                    (31 + 29) / 2)
    assert program_spans.self_ms(_run()) == pytest.approx(5.0)
    assert program_spans.span_ms(_run(), "absent") is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_span_metrics_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run_cell(workload, SEED, 2.0, True, time.perf_counter(),
                              torch.device("cuda", 0))
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(span_metrics(workload)) <= set(m)
    assert m["step.self.span_ms"] >= 0
    if workload == CELLS[1]:
        split = sum(m[f"hmr_quant.{p}.span_ms"]
                    for p in ("quantize", "products", "epilogue"))
        assert split == pytest.approx(m["hmr_quant.backbone.span_ms"],
                                      rel=0.02)
