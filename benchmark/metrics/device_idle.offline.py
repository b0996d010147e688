"""device_idle.offline: the share of the profiled slice's wall time in
which no kernel ran on the card (copies are not kernels), in %."""


def read(run):
    p = run.profile
    if not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
