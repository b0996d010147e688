"""The HMR 2.0 cell (``hmr2_bf16.offline_b512``) on the CPU at tiny widths:
a sound run is correct and reports its metrics, a broken timed path and the
control are not, and the FLOP count of the published widths.
``test_cell_on_the_card`` runs the cell on the card."""
import time

import numpy as np
import pytest
import torch
from test_bench_harness import altered, half_left_out, stale

from benchmark import harness
from benchmark.models import vit_flops

CELL = "hmr2_bf16.offline_b512"
SEED = 2 ** 32 + 103
TINY = {"mix": {"batch": 2, "span_batches": 1, "profiled_batches": 1,
                "checked_batches": 1},
        "config": {"image_size": 64, "crop_width": 48, "patch_size": 8,
                   "embed_dim": 64, "head_dim": 16, "num_heads": 4,
                   "mlp_dim": 256, "depth": 2, "context_dim": 64,
                   "decoder_dim": 64, "decoder_depth": 2, "decoder_heads": 4,
                   "decoder_dim_head": 16, "decoder_mlp_dim": 64,
                   "smpl_vertices": 300}}
SPANS = ("hmr2.backbone.span_ms", "hmr2.attention.span_ms",
         "hmr2.mlp.span_ms", "hmr2.head.span_ms")


def run_tiny(traced=False, **kw):
    return harness.run_cell(CELL, SEED, 0.3, traced, time.perf_counter(),
                            torch.device("cpu"), overrides=TINY, **kw)


def published():
    return harness.config_of("hmr2_vith_bf16")[0]


def test_sound_run_is_correct_and_reports_its_metrics():
    result = run_tiny(traced=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) >= {*SPANS, "step.h2d.span_ms",
                                      "step.self.span_ms"}
    assert "hmr.ief.span_ms" not in result["metrics"]
    assert set(result["spans_ms"]) >= {"hmr2.backbone", "hmr2.head"}
    untraced = run_tiny()
    assert set(untraced["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", (stale, half_left_out, altered))
def test_broken_timed_path_is_not_correct(fault):
    result = run_tiny(wrap_step=fault)
    assert not result["correct"], (fault.__name__, result["checks"])


def test_control_is_not_correct():
    limits = published()["limits"]
    result = run_tiny(side="control")
    assert any(c["value"] > limits[k]
               for k, c in result["checks"].items() if k in limits)
    assert not result["correct"]


@pytest.mark.parametrize("part,flops", (("block", 7_738_490_880),
                                        ("encoder", 248_009_195_520)))
def test_vit_flops_of_the_published_widths(part, flops):
    cfg = published()
    assert vit_flops.grid(cfg) == 192
    count = {"block": vit_flops.block_flops,
             "encoder": vit_flops.encoder_flops}[part](cfg)
    assert count == flops
    assert 251.0e9 < vit_flops.hmr2_smpl_flops(cfg) < 251.2e9


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run_cell(CELL, SEED, 2.0, True, time.perf_counter(),
                              torch.device("cuda", 0))
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["hmr2.backbone_roofline"] <= 100
    assert 0 < m["step_mfu"] <= 100
    assert m["hmr2.attention.span_ms"] + m["hmr2.mlp.span_ms"] >= \
        0.95 * m["hmr2.backbone.span_ms"]
    assert np.isfinite(result["device"]["busy_s"])
