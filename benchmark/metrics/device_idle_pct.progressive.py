"""device_idle_pct.progressive: 100 less the share of the traced window in which
a kernel, a copy or a set ran on the card (the union of their intervals),
read under the profiler."""


def read(run):
    if run["mode"] != "progressive" or not run.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["trace_window_s"])
