"""capture_s: the seconds the port's programs took to capture during the
set-up (``graphs.STATS["capture_s"]``)."""


def read(run):
    return run["capture_s"]
