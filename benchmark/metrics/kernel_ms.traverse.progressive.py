"""kernel_ms.traverse.progressive: device ms a frame of the kernels defined in
``csrc/dense_sweep.cu`` and ``csrc/bvh_walk.cu`` (the dense sweeps, the BVH
and treelet walks, the emissive walk), from the profiler's trace."""

from benchmark.trace_metrics import kernel_ms


def read(run):
    if run["mode"] != "progressive":
        return None
    return kernel_ms(run, ("dense_sweep.cu", "bvh_walk.cu"))
