"""step.copy_ms: the copies of one batch that ``HMRSMPLStep`` makes, the
images to the card and the outputs (vertices, camera) back to host numpy,
by CUDA events around them; the median over the traced batches."""


def read(run):
    return run.span_ms("step.copy")
