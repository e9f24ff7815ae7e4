"""The host side of ``tools/bench_torch_dense.py`` on the CPU: a 16x16 wave
recorded through the sweeps' plain versions, replayed and summarised as the
tool does on the card (``--reps 0``: no timing).

On the CPU the sweeps run their plain versions, which launch nothing: every
recorded call must leave ``dense.LAUNCHES`` unchanged (on the card the
recording checks each kernel's calls against its launches instead)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import bench_torch_dense as bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
import profile_torch_wave  # noqa: E402

from vulkan_raytracer_tpu_torch.ops import dense  # noqa: E402


@pytest.mark.parametrize("config, expect", [
    # cfg1: depth 4, so 5 closest and 5 shadow calls, and 2 pdf probes a bounce
    ("cfg1", {"dense_closest": 5, "dense_shadow": 5, "dense_emissive_pdf": 10}),
    # the textured glb: the alpha loop re-launches the closest sweep; no NEE
    # shadow sweep (alpha shadows go through the closest sweep)
    ("textured", {"dense_closest": 10, "dense_shadow": 0, "dense_emissive_pdf": 8}),
])
def test_recorded_wave_replays(config, expect):
    scene, pos, direction = profile_torch_wave.CONFIGS[config]
    tables = profile_torch_wave._scene(scene).upload("cpu")
    before = dict(dense.LAUNCHES)
    calls = cs.record_wave(tables, (pos, direction), 16, 16)
    assert dict(dense.LAUNCHES) == before
    assert {k: sum(c[0] == k for c in calls) for k in cs.DENSE_SWEEPS} == expect
    # the smoke's parity check of recorded calls (trivial here: the sweep is
    # its plain version on the CPU, but the gate-0 lanes must hold +0)
    assert cs.check_recorded(calls, config) == 0.0

    summary = bench.wave_summary(cs, calls, 0)
    totals = summary["per_kernel"]
    assert {k: t["launches"] for k, t in totals.items()} == {k: v for k, v in expect.items() if v}
    for entry, (kernel, args, _) in zip(summary["launches"], calls):
        assert entry["kernel"] == kernel and entry["rays"] == 2 * 16 * 16
        assert 0 <= entry["live"] <= entry["rays"] and entry["bound_ms"] > 0.0
        if kernel == "dense_closest":
            assert entry["live"] == int((args[3] > args[2]).sum())
        elif kernel == "dense_emissive_pdf":
            assert entry["live"] == int((args[2] != 0.0).sum())
            assert entry["pdf_hits"] <= entry["live"] * entry["triangles"]
    # every bounce after the first leaves fewer closest lanes live than the wave has
    live = [e["live"] for e in summary["launches"] if e["kernel"] == "dense_closest"]
    assert live[0] > 0 and min(live) < 2 * 16 * 16
    assert len(summary["digest_outputs"]) == 16
    # the replay is deterministic: a second summary gives the same digests
    again = bench.wave_summary(cs, calls, 0)
    assert (again["digest_inputs"], again["digest_outputs"]) == (
        summary["digest_inputs"], summary["digest_outputs"])
