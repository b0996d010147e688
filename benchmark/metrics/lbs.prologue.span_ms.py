"""lbs.prologue.span_ms: ``core/fused_lbs.py`` ``lbs_prologue`` on one batch
(torch ops, paced by the host).  The program's own span ``lbs.prologue``, by
its CUDA events, summed within a step; the median over the profiled batches."""
from benchmark import program_spans


def read(run):
    return program_spans.span_ms(run, "lbs.prologue")
