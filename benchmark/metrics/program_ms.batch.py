"""program_ms.batch: device ms a frame inside the port's program launches,
each timed by the CUDA event pair the port records around its graph launch
while the profiler runs (``utils/spans.py``), over the frames the traced
window rendered."""

from benchmark.span_metrics import program_ms


def read(run):
    return program_ms(run, "batch")
