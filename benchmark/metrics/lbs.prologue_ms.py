"""lbs.prologue_ms: ``core/fused_lbs.py`` ``lbs_prologue`` on one batch
(torch ops, paced by the host), by CUDA events; the median over the traced
batches."""


def read(run):
    return run.span_ms("lbs.prologue")
