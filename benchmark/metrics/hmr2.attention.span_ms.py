"""hmr2.attention.span_ms: the self-attention halves of ``models/hmr2.py``'s
32 encoder blocks on one batch (LN1, ``qkv``, scaled dot-product attention,
``proj``, the residual add).  The program's own spans ``hmr2.attention``, by
their CUDA events, summed within a step; the median over the profiled
batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr2.attention")
