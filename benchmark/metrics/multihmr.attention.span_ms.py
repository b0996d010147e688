"""multihmr.attention.span_ms: the self-attention halves of
``models/multihmr.py``'s 24 DINOv2 blocks on one batch over 4,097 tokens
(``qkv``, scaled dot-product attention, ``proj``, then ``add_layernorm``:
the LayerScaled residual add and ``norm2`` with its bf16 cast).  The
program's own spans ``multihmr.attention``, by their CUDA events, summed
within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "multihmr.attention")
