"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells beside the real ones, and the card for the few tests that need
one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.spec import ROOT

#: tiny cells: (name, config, mode); each takes its limits from the real
#: cell of the same configuration and mode
TINY = (("tiny_cornell.batch", "cornell", "batch"),
        ("tiny_cornell.progressive", "cornell", "progressive"),
        ("tiny_hall.batch", "hall", "batch"))


@pytest.fixture(scope="session", autouse=True)
def _threads():
    torch.set_num_threads(min(4, torch.get_num_threads()))


def make_root(dst: Path) -> Path:
    """A checkout-like directory: ``BENCHMARK.json`` and ``benchmark/``
    copied, with the :data:`TINY` cells added as files and entries."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, config, mode in TINY:
        traffic = dict(mode=mode, width=16, height=12, depth=3, warm_frames=2,
                       trace_frames=3, check_pixels=48)
        if mode == "batch":
            traffic["spp"] = 4
        (dst / "benchmark" / "traffic" / f"tiny_{mode}.json").write_text(json.dumps(traffic))
        real = f"{config}.{mode}"
        shutil.copy(dst / "benchmark" / "limits" / f"{real}.json",
                    dst / "benchmark" / "limits" / f"{name}.json")
        bench["workloads"].append(dict(name=name, config=config, traffic=f"tiny_{mode}",
                                       chips=1, why="a tiny cell of the CPU tests"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture()
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
