"""kernel_ms.shade.progressive: device ms a frame of the kernels defined in
``csrc/shade.cu`` (the bounce's shading), from the profiler's trace."""

from benchmark.trace_metrics import kernel_ms


def read(run):
    if run["mode"] != "progressive":
        return None
    return kernel_ms(run, ("shade.cu",))
