"""The host side of ``chip_smoke.py``: its ptxas parsing, its bounds and its
refusal to run without a card.  The card-side phases run only on the card
(``python3 chip_smoke.py``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REPORT = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N_bvh_walk_cu19treelet_walk_kernelILb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N_bvh_walk_cu19treelet_walk_kernelILb1EEEv
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size, 3456 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_dense_sweep_cu14closest_kernelEPKfi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N_dense_sweep_cu14closest_kernelEPKfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 9216 bytes smem
"""


def test_ptxas_table_reads_each_variant():
    assert cs.ptxas_table(REPORT) == {
        "treelet_walk_shadow": {"stack_frame": 16, "spill_stores": 16, "spill_loads": 12,
                                "registers": 64},
        "dense_closest": {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
                          "registers": 40},
    }


@pytest.mark.parametrize("ops, nbytes, by", [(67e9, 1e6, "operations"), (1e6, 3.35e9, "bytes")])
def test_bound_is_the_larger_of_the_two_times(ops, nbytes, by):
    b = cs.bound(ops, nbytes)
    assert b["bound_by"] == by and b["bound_ms"] == pytest.approx(1.0)


def test_smoke_refuses_to_run_without_a_card():
    """Without CUDA the smoke exits nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run in full")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and '"ok"' in line for line in proc.stdout.splitlines())
    assert "CUDA is not available" in proc.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "not json")
