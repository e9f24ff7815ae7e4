"""setup_s: process start to the window's start (import, CUDA context, the
kernels from the build cache, the scene made and uploaded, the warm frames
that capture the programs)."""


def read(run):
    return run["setup_s"]
