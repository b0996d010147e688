"""hmr2.mlp.span_ms: the MLP halves of ``models/hmr2.py``'s 32 encoder blocks
on one batch (LN2, ``fc1``, GELU, ``fc2``, the residual add).  The program's
own spans ``hmr2.mlp``, by their CUDA events, summed within a step; the
median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "hmr2.mlp")
