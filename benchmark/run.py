"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 benchmark/run.py --workload cornell.batch --seed 7 --seconds 10 --trace 0

Run it from the checkout's root.  Kernels build into the port's own
``vulkan_raytracer_tpu_torch/build/`` on a checkout's first run; later runs
load them from there.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
