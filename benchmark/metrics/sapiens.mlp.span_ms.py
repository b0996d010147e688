"""sapiens.mlp.span_ms: the MLP halves of the Sapiens encoder's 48 blocks
on one batch (``fc1`` 1,920 -> 7,680, GELU, ``fc2``, then
``add_layernorm``: the residual add and the next block's ``norm1`` with its
bf16 cast, or the final LayerNorm in float32).  The program's own spans
``sapiens.mlp``, by their CUDA events, summed within a step; the median
over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "sapiens.mlp")
