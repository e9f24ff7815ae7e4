"""The harness is driven by data: a new cell, configuration, traffic mix
and metric are new files and entries, found by name; and BENCHMARK.json
keeps to the shape the benchmark's contract gives it."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.spec import ROOT, Spec

from .conftest import make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    d = root / "benchmark"
    (d / "scenes" / "one_quad.py").write_text(
        "import numpy as np\n"
        "from benchmark.scenedata import Material, SceneData\n"
        "def build(size=1.0):\n"
        "    s = SceneData()\n"
        "    m = Material(); m.emissive_factor = np.ones(3, np.float32)\n"
        "    p = np.array([[0, 0, 0], [size, 0, 0], [0, size, 0]], np.float32)\n"
        "    s.add(p, np.tile([0, 0, 1], (3, 1)), [0, 1, 2], m)\n"
        "    return s\n")
    (d / "configs" / "one_quad.json").write_text(json.dumps(
        {"name": "one_quad", "scene": "one_quad", "scene_args": {"size": 2.0},
         "camera": {"position": [0, 0, 3], "direction": [0, 0, -1]}}))
    (d / "traffic" / "batch_8x8.json").write_text(json.dumps(
        {"mode": "batch", "width": 8, "height": 8, "spp": 1, "depth": 1, "warm_frames": 1,
         "trace_frames": 1, "check_pixels": 4}))
    (d / "limits" / "one_quad.batch.json").write_text('{"u8_mean_abs": 0.5}')
    (d / "metrics" / "triangles.batch.py").write_text(
        "def read(run):\n    return run.get('triangles')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "one_quad", "source": "x", "file":
                             "benchmark/configs/one_quad.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "one_quad.batch", "config": "one_quad",
                               "traffic": "batch_8x8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "triangles.batch", "unit": "tris", "better": "lower",
                               "source": "program_counter", "layer": "scene",
                               "moves": "setup_s", "workloads": ["one_quad.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(root)
    cell = spec.workload("one_quad.batch")
    config = spec.config(cell["config"])
    assert spec.traffic(cell["traffic"])["width"] == 8
    assert spec.limits("one_quad.batch") == {"u8_mean_abs": 0.5}
    assert spec.scene_builder(config)(**config["scene_args"]).meshes[0].positions[1, 0] == 2.0
    assert spec.reader("triangles.batch")({"triangles": 1}) == 1
    assert [m["name"] for m in spec.per_layer("one_quad.batch")] == [
        "upload_s", "capture_s", "triangles.batch"]
    assert [m["name"] for m in spec.end_to_end("one_quad.batch")] == ["setup_s"]
    # and a run of it goes through on the CPU, the new metric's reader in it
    result = harness.run("one_quad.batch", 3, 0.01, False, root=root, device="cpu")
    assert result["correct"] and result["failed"] == 0
    assert list(result["metrics"]) == ["setup_s"]


def test_per_layer_without_workloads_follows_its_end_to_end_metric(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "upload_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "x", "moves": "frames_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    assert "frames_per_s" in [m["name"] for m in spec.end_to_end("cornell.progressive")]
    picked = [m for m in spec.per_layer("cornell.progressive") if m["moves"] == "frames_per_s"]
    assert any(m["name"] == "upload_s" for m in picked)
    assert not any(m["moves"] == "frames_per_s" for m in spec.per_layer("cornell.batch"))


def test_benchmark_json_keeps_the_contracts_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    spec = Spec()
    for w in bench["workloads"]:
        reported = {m["moves"] for m in spec.per_layer(w["name"])}
        assert len(spec.end_to_end(w["name"])) >= 2 and reported


@pytest.mark.parametrize("cell", ["cornell.batch", "hall.batch", "cornell.progressive",
                                  "hall.progressive"])
def test_each_cell_reads_its_own_limits(cell):
    limits = Spec().limits(cell)
    assert set(limits) == {"u8_mean_abs"} and limits["u8_mean_abs"] > 0
