"""multihmr.backbone.span_ms: ``models/multihmr.py`` ``DinoViT`` on one batch
(the patch embedding, the cls token and position table, 24 blocks and
``norm``; bf16 GEMMs, float32 LayerNorms, LayerScale and residual stream).
The program's own span ``multihmr.backbone``, by its CUDA events, summed
within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "multihmr.backbone")
