"""The Multi-HMR cell (``multihmr_bf16.offline_b64``) on the CPU at tiny
widths (a 56^2 image of 14 x 14 patches, 2 blocks of 256 in 4 heads, 2
persons; at 64 wide the encoder's branches are too small beside the stream
for LayerScale to show): a sound run is correct and reports its metrics; the
control and steps that drop LayerScale, the ray encoding, the expression or
the betas, or swap two persons, are not; the FLOP count of the published widths.
``test_cell_on_the_card`` runs the cell on the card."""
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.models import dinov2_flops

CELL = "multihmr_bf16.offline_b64"
SEED = 2 ** 32 + 107
TINY = {"mix": {"batch": 2, "span_batches": 1, "profiled_batches": 1,
                "checked_batches": 1},
        "config": {"image_size": 56, "embed_dim": 256, "head_dim": 64,
                   "num_heads": 4, "mlp_dim": 1024, "depth": 2,
                   "pos_embed_grid": 3, "context_dim": 256 + 99,
                   "hph_dim": 64, "hph_heads": 4, "hph_dim_head": 16,
                   "hph_mlp_dim": 64, "token_dim": 256 + 99 + 331,
                   "persons": 2, "centres": [5, 14], "smpl_vertices": 300}}
SPANS = ("multihmr.backbone.span_ms", "multihmr.attention.span_ms",
         "multihmr.mlp.span_ms", "multihmr.head.span_ms")


def run_tiny(traced=False, **kw):
    return harness.run_cell(CELL, SEED, 0.3, traced, time.perf_counter(),
                            torch.device("cpu"), overrides=TINY, **kw)


def published():
    return harness.config_of("multihmr_896_l_bf16")[0]


def test_sound_run_is_correct_and_reports_its_metrics():
    result = run_tiny(traced=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) >= {*SPANS, "step.h2d.span_ms",
                                      "step.self.span_ms",
                                      "step.h2d.hidden_share"}
    assert "hmr2.backbone.span_ms" not in result["metrics"]
    assert set(result["spans_ms"]) >= {"multihmr.backbone", "multihmr.head",
                                       "fused_lbs"}
    untraced = run_tiny()
    assert set(untraced["metrics"]) == {"frames_per_s", "setup_s"}


# -- the timed path broken underneath -----------------------------------
def no_layerscale(step):
    """The encoder's LayerScale dropped: every gamma 1."""
    with torch.no_grad():
        for block in step.hmr.backbone.encoder.blocks:
            block.ls1.gamma.fill_(1.0)
            block.ls2.gamma.fill_(1.0)
    return step


def no_rays(step):
    """The context without its camera rays' encoding."""
    step.hmr.x_attention_head.rays.zero_()
    return step


def no_expression(step):
    """The face without its expression: every expression coefficient 0."""
    with torch.no_grad():
        step.hmr.x_attention_head.decexpression.weight.zero_()
        step.hmr.x_attention_head.decexpression.bias.zero_()
    return step


def no_shape(step):
    """Every body at the mean shape: every beta 0."""
    with torch.no_grad():
        step.hmr.x_attention_head.decshape.weight.zero_()
    return step


def persons_swapped(step):
    """Each frame's first two persons get each other's answers."""
    def broken(host):
        verts, transl = step(host)
        return verts[:, [1, 0]], transl[:, [1, 0]]
    return broken


@pytest.mark.parametrize("fault", (no_layerscale, no_rays, no_expression,
                                   no_shape, persons_swapped))
def test_broken_timed_path_is_not_correct(fault):
    result = run_tiny(wrap_step=fault)
    assert not result["correct"], (fault.__name__, result["checks"])


def test_control_is_not_correct():
    limits = published()["limits"]
    result = run_tiny(side="control")
    assert any(c["value"] > limits[k]
               for k, c in result["checks"].items() if k in limits)
    assert not result["correct"]


@pytest.mark.parametrize("part,flops", (
    ("attention", 103_121_162_240), ("mlp", 68_736_253_952),
    ("encoder", 4_129_510_490_112)))
def test_dinov2_flops_of_the_published_widths(part, flops):
    cfg = published()
    assert dinov2_flops.patches(cfg) == 4096
    count = {"attention": dinov2_flops.attention_flops,
             "mlp": dinov2_flops.mlp_flops,
             "encoder": dinov2_flops.encoder_flops}[part](cfg)
    assert count == flops
    assert 9e9 < dinov2_flops.head_flops(cfg) < 19e9
    assert 4_139e9 < dinov2_flops.multihmr_smplx_flops(cfg) < 4_141e9


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = harness.run_cell(CELL, SEED, 5.0, True, time.perf_counter(),
                              torch.device("cuda", 0))
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["multihmr.attention_roofline"] <= 100
    assert 0 < m["step_mfu"] <= 100
    assert m["multihmr.attention.span_ms"] + m["multihmr.mlp.span_ms"] >= \
        0.95 * m["multihmr.backbone.span_ms"]
    assert result["counters"]["launches.add_layernorm.profiled"] == 48 * 4
    assert np.isfinite(result["device"]["busy_s"])
