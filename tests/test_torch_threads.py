"""One intra-op thread for the port's CPU tests.

The tier-1 command runs the suite in six pytest-xdist workers at once, each
a process whose torch starts one OpenMP thread a core: together they
oversubscribe the cores, and every parallel op's threads spin waiting for
threads that are not scheduled.  A test that runs many small ops slows ~30x
so: ``tests/test_torch_lane_diff.py``'s two-upload comparison took 3.8 s
with one thread and 115 s with eight beside seven busy cores, and 1,274 s
in a whole run of the suite.  Every worker collects this module before it
runs a test, so importing it sets one intra-op thread for the whole
process, and both sides of every comparison run with it.
"""

import torch

torch.set_num_threads(1)


def test_one_intra_op_thread():
    """The setting is in force where the tests run."""
    assert torch.get_num_threads() == 1
