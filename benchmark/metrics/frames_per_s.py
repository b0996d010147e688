"""frames_per_s: frames whose outputs reached host memory as numpy in the
measured window, over the whole window (host clock)."""


def read(run):
    w = run.window
    if not w.get("frames"):
        return None
    return w["frames"] / w["seconds"]
