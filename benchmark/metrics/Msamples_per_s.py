"""Msamples_per_s: pixel-samples of every whole frame of the window, over
the wall seconds of those frames."""

from benchmark.window import rate


def read(run):
    if run["mode"] != "batch":
        return None
    return rate(run["frames"] * run["pixels"] * run["spp"], run["window_s"]) / 1e6
