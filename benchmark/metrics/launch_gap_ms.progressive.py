"""launch_gap_ms.progressive: device ms a frame between the port's program
launches (the mean gap from one launch's end event to the next one's start,
times the launches, over the frames rendered): what the card spends outside
the programs, busy or idle, while the host runs the frame's other spans."""

from benchmark.span_metrics import launch_gap_ms


def read(run):
    return launch_gap_ms(run, "progressive")
