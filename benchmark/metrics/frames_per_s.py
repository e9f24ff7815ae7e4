"""frames_per_s: the frames handed out in the window over its wall
seconds."""

from benchmark.window import rate


def read(run):
    if run["mode"] != "progressive":
        return None
    return rate(run["frames"], run["window_s"])
