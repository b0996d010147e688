"""multihmr.mlp.span_ms: the MLP halves of ``models/multihmr.py``'s 24 DINOv2
blocks on one batch (``fc1``, GELU, ``fc2``, then ``add_layernorm``: the
LayerScaled residual add and the next block's ``norm1`` with its bf16 cast,
or ``norm`` in float32).  The program's own spans ``multihmr.mlp``, by their
CUDA events, summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "multihmr.mlp")
