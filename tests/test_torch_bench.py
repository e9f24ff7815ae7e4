"""The port's bench (``vulkan_raytracer_tpu_torch/bench.py``) against the
repository root's ``bench.py`` on the CPU.

* ``gate_fingerprint`` of the port's upload equals the JAX bench's of the JAX
  upload for all five configs (the built-in Cornell box for cfg1), and the
  fingerprint stored beside each committed golden.
* The built-in Cornell box's golden in ``bench_goldens_torch.npz`` carries
  that fingerprint, and the port's CPU render of the gate crop (48x48, 4 spp,
  depth 3) passes the gate through ``quality_gate``.
* Both ``main()`` functions, with a recording stand-in for the scene set-up
  and the timed render and a fake clock, render the same (config, rep)
  sequence and print the same lines in the same order, with and without a
  budget that trims reps (never configs).
* cfg1 is the built-in box unless ``--cornell-gltf`` names a glTF.
* The module imports neither jax nor the JAX package, and ``main()`` exits
  nonzero without CUDA, having rendered nothing.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# importing bench.py sets VKRT_LOG_LEVEL (and JAX's cache) for its own run;
# the CLI subprocesses of other tests in this worker must not inherit them
_ENV = dict(os.environ)
import bench as jbench  # noqa: E402

for _k in set(os.environ) - set(_ENV):
    del os.environ[_k]
from vulkan_raytracer_tpu.scene.builtin import cornell_box_scene as j_cornell  # noqa: E402

import torch_glb_assets  # noqa: E402

from vulkan_raytracer_tpu_torch import bench as tbench  # noqa: E402
from vulkan_raytracer_tpu_torch.render import renderer  # noqa: E402

BUILTIN_KEY = "cfg1_cornell_builtin_512x512_d4_64spp"


def test_configs_are_bench_py_configs():
    """Keys, cameras, frames, spp, depth, gate crops and reps (the scene
    builders are each package's own; the port warms every config up on a
    whole frame, which captures every bounce its reps replay)."""
    fields = ("key", "cam", "w", "h", "spp", "depth", "crop", "reps")
    assert ([{f: c.get(f) for f in fields} for c in tbench.CONFIGS]
            == [{f: c.get(f) for f in fields} for c in jbench.CONFIGS])


@pytest.mark.parametrize("i", range(5), ids=[c["key"][:4] for c in tbench.CONFIGS])
def test_gate_fingerprint_matches_jax_bench(i):
    """The port's digest of its own upload is the JAX bench's of the JAX
    upload, and the golden's stored one (for cfg1: the built-in box's, in
    the port's golden file)."""
    jcfg, tcfg = jbench.CONFIGS[i], tbench.CONFIGS[i]
    # cfg1: the built-in box in both packages, whatever checkout sits beside
    jtables = jcfg["build"]()[0] if i < 4 else j_cornell().upload()
    ttables = (tcfg["build"]() if i < 4 else tbench.cornell_box_scene()).upload("cpu")
    cw, cspp, cdepth = tcfg["crop"]
    fp_jax = jbench.gate_fingerprint(jtables, jbench._cam(*jcfg["cam"]), cw, cspp, cdepth)
    fp_port = tbench.gate_fingerprint(ttables, tbench._cam(*tcfg["cam"]), cw, cspp, cdepth)
    assert fp_port == fp_jax
    key = tcfg["key"] if i < 4 else BUILTIN_KEY
    assert str(tbench.load_goldens()[f"fp_{key}"]) == fp_port


def test_builtin_cornell_golden_passes_the_gate_on_the_cpu():
    """The golden of ``tools/gen_torch_bench_goldens.py`` (the JAX NumPy
    oracle) against the port's CPU render of the same crop: RMSE measured
    2.3e-8, bar 2e-3."""
    with np.load(tbench.GOLDENS_TORCH, allow_pickle=False) as f:
        assert sorted(f.files) == [f"fp_{BUILTIN_KEY}", f"golden_{BUILTIN_KEY}"]
        assert str(f[f"fp_{BUILTIN_KEY}"]).startswith("7558838")
        assert f[f"golden_{BUILTIN_KEY}"].shape == (48, 48, 3)
    cfg = tbench.cornell_config()
    assert cfg["key"] == cfg["gate"] == BUILTIN_KEY
    tables = tbench.cornell_box_scene().upload("cpu")
    rmse = tbench.quality_gate(BUILTIN_KEY, tables, tbench._cam(*cfg["cam"]), cfg["crop"],
                               tbench.load_goldens())
    assert rmse < 1e-6, rmse


def test_gate_refuses_a_stale_fingerprint():
    cfg = tbench.CONFIGS[-1]
    goldens = dict(tbench.load_goldens())
    goldens[f"fp_{BUILTIN_KEY}"] = np.str_("0" * 64 + ":4")
    tables = tbench.cornell_box_scene().upload("cpu")
    with pytest.raises(SystemExit, match="stale"):
        tbench.quality_gate(BUILTIN_KEY, tables, tbench._cam(*cfg["cam"]), cfg["crop"],
                            goldens)
    with pytest.raises(SystemExit, match="no committed golden"):
        tbench.quality_gate("cfg9", tables, tbench._cam(*cfg["cam"]), cfg["crop"], goldens)


class _Clock:
    """Seconds that pass only when a stand-in frame renders."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    monotonic = perf_counter


#: seconds of one stand-in frame per config
FRAME_S = {"cfg1": 4.0, "cfg2": 2.0, "cfg3": 3.0, "cfg4": 5.0, "cfg5": 11.0}
RAYS = 10 ** 8


def _run_jax_main(monkeypatch, capsys, budget):
    clock, calls = _Clock(), []
    # cfg1's source by bench.py's own rule (the box is small to upload; its
    # log line is not one of the bench's lines)
    src = jbench.CONFIGS[-1]["build"]()[1]
    capsys.readouterr()

    def init(self, cfg, goldens):
        self.cfg, self.times, self.rays = cfg, [], 0
        self.key = cfg["key"].format(src=src)
        self.rmse, self.rmse_key, self.tables, self.cam = 0.0, "rmse", None, None

        def render(*args, **kwargs):
            calls.append((self.key, len(self.times)))
            clock.t += FRAME_S[cfg["key"][:4]]
            return np.ones(1, np.uint8), RAYS

        self._render_image = render

    monkeypatch.setattr(jbench._Cfg, "__init__", init)
    monkeypatch.setattr(jbench, "time", clock)
    monkeypatch.setattr(jbench, "_elapsed", clock.perf_counter)
    monkeypatch.setattr(jbench, "BUDGET", budget)
    jbench.main()
    return calls, capsys.readouterr().out.splitlines()


def _port_standins(monkeypatch, budget):
    """The port's bench with a stand-in set-up and render on a fake clock;
    returns (the (config, rep) renders, the configs prepared)."""
    clock, calls, prepared = _Clock(), [], []

    def prepare(self, goldens, device):
        prepared.append(self.cfg["key"])
        self.rmse, self.rmse_key = 0.0, "rmse"
        self.upload_s = self.gate_s = self.warm_s = 0.0

    def timed_render(self):
        calls.append((self.key, len(self.times)))
        clock.t += FRAME_S[self.cfg["key"][:4]]
        self.times.append(FRAME_S[self.cfg["key"][:4]])
        self.rays = RAYS

    def render_image(*args, **kwargs):
        raise AssertionError("the stand-in run rendered")

    monkeypatch.setattr(tbench._Cfg, "_prepare", prepare)
    monkeypatch.setattr(tbench._Cfg, "_timed_render", timed_render)
    monkeypatch.setattr(tbench, "_elapsed", clock.perf_counter)
    monkeypatch.setattr(tbench, "_setup", lambda device: 0.0)
    monkeypatch.setattr(tbench, "nvidia_smi_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(tbench, "BUDGET", budget)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(renderer, "render_image", render_image)
    return calls, prepared


def _run_port_main(monkeypatch, capsys, budget, gltf):
    calls, prepared = _port_standins(monkeypatch, budget)
    assert tbench.main(["--cornell-gltf", gltf] if gltf else []) == 0
    c1 = tbench.cornell_config(gltf)
    assert prepared == [c["key"] for c in [c1, *tbench.CONFIGS[:-1]]]
    return calls, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("budget", [2200.0, 60.0, 0.0], ids=["full", "trimmed", "one_rep"])
def test_schedule_equals_bench_py(monkeypatch, capsys, budget):
    """The same (config, rep) renders in the same order, and the same lines:
    configs 2-5, the summary, cfg1 last (the port's preceded by the card's
    nvidia-smi line).  The budget trims reps and never a config.  The port
    renders cfg1 from the glTF that bench.py loads, when it finds one, given
    as ``--cornell-gltf``."""
    jcalls, jout = _run_jax_main(monkeypatch, capsys, budget)
    jlines = [json.loads(s) for s in jout]
    gltf = jbench.REFERENCE_CORNELL if "_refgltf_" in jlines[-1]["metric"] else None
    tcalls, tout = _run_port_main(monkeypatch, capsys, budget, gltf)
    assert tcalls == jcalls
    assert tout[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    tlines = [json.loads(s) for s in tout[1:]]
    assert [x["metric"] for x in tlines] == [x["metric"] for x in jlines]
    keys = [c["key"] for c in [*tbench.CONFIGS[:-1], tbench.cornell_config(gltf)]]
    names = [f"Mrays_{k}" for k in keys]
    assert [x["metric"] for x in tlines] == names[:-1] + ["bench_summary", names[-1]]
    reps = {k: sum(c == k for c, _ in tcalls) for k in keys}
    if budget == 2200.0:
        assert list(reps.values()) == [c["reps"] for c in jbench.CONFIGS]
    elif budget == 0.0:
        assert set(reps.values()) == {1}
    else:
        assert all(n >= 1 for n in reps.values())
        assert sum(reps.values()) < sum(c["reps"] for c in jbench.CONFIGS)
    for j, t in zip(jlines, tlines):  # bench.py's fields and values, but vs_baseline
        assert "vs_baseline" not in t
        j.pop("vs_baseline", None)
        assert {k: t.get(k) for k in j} == j


def test_reps_cap(monkeypatch):
    """``run(reps=1)`` (the smoke's run): one rep of every config, cfg1 first."""
    calls, _ = _port_standins(monkeypatch, 2200.0)
    others, c1, summary = tbench.run(torch.device("cpu"), reps=1)
    order = [tbench.cornell_config(), *tbench.CONFIGS[:-1]]
    assert calls == [(c["key"], 0) for c in order]
    assert c1.key == BUILTIN_KEY
    assert [c.reps for c in (c1, *others)] == [1] * 5
    assert summary[c1.key] == c1.line()["value"]


@pytest.mark.parametrize("captures", [0, 2], ids=["warm", "captured"])
def test_a_rep_that_captures_a_graph_ends_the_run(monkeypatch, captures):
    """A timed rep that captured a CUDA graph timed a capture: the run ends
    nonzero; a rep that replayed only counts 0 in ``graphs_captured``."""
    from vulkan_raytracer_tpu_torch.render import graphs

    def render_image(*args, **kwargs):
        graphs.STATS["captured"] += captures
        return np.ones((2, 2, 3), np.uint8), RAYS

    c = object.__new__(tbench._Cfg)
    c.cfg, c.key, c.tables, c.cam, c.reps = tbench.CONFIGS[0], "cfg2", None, None, 1
    c.times, c.captured, c.rmse, c.rmse_key = [], [], 0.0, "rmse"
    c.upload_s = c.gate_s = c.warm_s = 0.0
    monkeypatch.setattr(renderer, "render_image", render_image)
    monkeypatch.setattr(tbench, "launch_counts",
                        lambda: {"dense": {"pdf": 1}, "traverse": {"treelet_closest": 1,
                                                                   "treelet_shadow": 1}})
    for name in ("reset_peak_memory_stats", "synchronize", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    if captures:
        with pytest.raises(SystemExit, match=f"captured {captures} graphs"):
            c._timed_render()
    else:
        c._timed_render()
        assert c.line()["graphs_captured"] == [0]


def test_cornell_source_is_the_builtin_box_unless_a_gltf_is_given(tmp_path):
    """cfg1 reads nothing outside the checkout by itself: the built-in box,
    gated on the port's golden; ``--cornell-gltf`` loads the given file and
    gates it on bench.py's cfg1 golden (the unformatted key)."""
    box = tbench.cornell_config()
    assert box["key"] == box["gate"] == BUILTIN_KEY
    assert box["build"]().upload("cpu").num_triangles == j_cornell().upload().num_triangles
    path = tmp_path / "textured.glb"
    path.write_bytes(torch_glb_assets.textured_glb_bytes())
    gltf = tbench.cornell_config(str(path))
    assert gltf["key"] == "cfg1_cornell_refgltf_512x512_d4_64spp"
    assert gltf["gate"] == tbench.CONFIGS[-1]["key"] == jbench.CONFIGS[-1]["key"]
    assert f"golden_{gltf['gate']}" in tbench.load_goldens()
    assert gltf["build"]().upload("cpu").num_triangles > 0
    assert {k: v for k, v in gltf.items() if k not in ("key", "gate", "build")} == \
        {k: v for k, v in box.items() if k not in ("key", "gate", "build")}


def test_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, vulkan_raytracer_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vulkan_raytracer_tpu', 'bench')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_main_refuses_to_run_without_cuda(monkeypatch):
    """In a subprocess with no visible card: a nonzero exit, the reason on
    stderr, nothing on stdout; in process, ``main()`` raises before any
    render."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run in full")
    proc = subprocess.run([sys.executable, "-m", "vulkan_raytracer_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
    rendered = []
    monkeypatch.setattr(renderer, "render_image", lambda *a, **k: rendered.append(a))
    with pytest.raises(SystemExit) as exc:
        tbench.main([])
    assert exc.value.code not in (0, None) and not rendered
