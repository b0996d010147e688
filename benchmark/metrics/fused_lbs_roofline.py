"""fused_lbs_roofline: the least time the card could take for one batch's
skinning (``roofline.lbs_seconds``: its bytes at the memory bandwidth or its
operations at the bf16 peak, whichever is longer) over the device time of
one call of ``csrc/fused_lbs.cu`` (its frame split and its products), from
the profiled slice's kernels, in %."""
from benchmark import roofline

KERNELS = ("fused_lbs_kernel", "split_frames_kernel")


def read(run):
    kernels = run.profile.get("kernels", [])
    calls = sum(1 for name, _, _ in kernels if KERNELS[0] in name)
    us = sum(dur for name, _, dur in kernels
             if any(k in name for k in KERNELS))
    bound = roofline.lbs_seconds(run.cfg, run.mix["batch"], run.kind)
    if not calls or not us or bound is None:
        return None
    return 100.0 * bound / (us * 1e-6 / calls)
