"""sapiens.attention.span_ms: the self-attention halves of the Sapiens
encoder's 48 blocks on one batch over 3,072 tokens (``qkv``, scaled
dot-product attention over 32 heads of 60 padded to 64, ``proj``, then
``add_layernorm``: the residual add and ``norm2`` with its bf16 cast).  The
program's own spans ``sapiens.attention``, by their CUDA events, summed
within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "sapiens.attention")
