"""step_mfu: the whole step's model operations a frame (``roofline``:
ResNet-50's convolutions, the IEF regressor, the skinning) times the traced
run's window frames/s, over the card's peak in the precision the
configuration computes in, in %."""
from benchmark import roofline


def read(run):
    w = run.window
    peak = roofline.peak(run.kind, run.config.PEAK)
    if not w.get("frames") or peak is None:
        return None
    rate = w["frames"] / w["seconds"]
    return 100.0 * run.config.flops_per_frame(run.cfg) * rate / peak
