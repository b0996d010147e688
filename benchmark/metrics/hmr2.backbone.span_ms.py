"""hmr2.backbone.span_ms: ``models/hmr2.py`` ``ViTH`` on one batch (the crop,
the patch embedding, 32 blocks and ``last_norm``; bf16 GEMMs, float32
LayerNorms and residual stream).  The program's own span ``hmr2.backbone``,
by its CUDA events, summed within a step; the median over the profiled
batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr2.backbone")
