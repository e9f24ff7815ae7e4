"""What the benchmark's processes load: never JAX or the JAX package, and
in the reference nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vulkan_raytracer_tpu"}


def _top_level_after(code: str) -> set:
    """The top-level names of ``sys.modules`` after ``code`` ran in a fresh
    interpreter at the checkout's root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_everything_it_loads_import_no_jax():
    names = _top_level_after(
        "from benchmark import harness, control, spec\n"
        "from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer\n"
        "from vulkan_raytracer_tpu_torch.scene import camera, scenegraph\n"
        "import vulkan_raytracer_tpu_torch.ops._ext\n"
        "s = spec.Spec()\n"
        "for m in s.bench['end_to_end'] + s.bench['per_layer']: s.reader(m['name'])\n"
        "for c in s.bench['configs']: s.scene_builder(s.config(c['name']))\n")
    assert "vulkan_raytracer_tpu_torch" in names  # the port, compared whole
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _top_level_after(
        "from benchmark.reference import pathtracer\n"
        "from benchmark import camera, compare, scenedata, window\n"
        "from benchmark.scenes import cornell, hall\n")
    assert not names & (FORBIDDEN | {"vulkan_raytracer_tpu_torch"})


def test_reference_sources_import_nothing_of_the_port_or_jax():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN | {"vulkan_raytracer_tpu_torch"}, (path, mod)


def test_harness_reads_nothing_of_the_old_benchmark():
    old = ("bench_goldens", "BENCH_r", "MULTICHIP_r", "vulkan_raytracer_tpu_torch.bench",
           "import bench")
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for word in old:
            assert word not in text, (path, word)
