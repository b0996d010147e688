"""sapiens.backbone.span_ms: the Sapiens encoder (``models/hmr2.py`` ``ViTH``
at Sapiens' widths) on one batch (the crop, the patch embedding, the
position table, 48 blocks and the final LayerNorm; bf16 GEMMs, float32
LayerNorms and residual stream).  The program's own spans
``sapiens.backbone``, one a copy chunk, by their CUDA events, summed within
a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "sapiens.backbone")
