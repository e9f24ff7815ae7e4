"""frame_ms_p95: the 95th percentile (nearest rank) of all intervals
between the images successive ``draw_frame`` calls handed out."""

from benchmark.window import percentile


def read(run):
    if run["mode"] != "progressive" or not run["intervals"]:
        return None
    return percentile(run["intervals"], 95) * 1e3
