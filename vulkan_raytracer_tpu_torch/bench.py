"""The bench of the torch port: bench.py's five configs on one NVIDIA card.

Port of the repository root's ``bench.py`` (which drives the JAX package).
Run from the root of a checkout, on a machine with a card:

    python3 -m vulkan_raytracer_tpu_torch.bench [--cornell-gltf PATH]

Configs (bench.py:131-152; the scenes of ``scene/procedural.py`` and
``scene/builtin.py``):

1. The Cornell box at 512x512, depth 4, 64 spp: the built-in box, or, given
   ``--cornell-gltf PATH``, that glTF (the reference renderer's
   ``res/CornellBox.gltf``) through ``Scene.load_model``; the metric name
   says which (``{src}``: ``builtin`` or ``refgltf``).  bench.py loads the
   glTF when it exists at a fixed path outside the checkout; this bench
   reads nothing outside its checkout unless told to.  Its line prints last.
2. The 262k-triangle dragon, 512x512, depth 4, 4 spp.
3. The 98k-triangle glass and rough-transmission chess set, 512x512, depth 6.
4. The 256k-triangle hall under the procedural HDR sky, 960x540, depth 4,
   8 spp.
5. The multi-model scene, 1920x1080, depth 8, 8 spp.

Each line: ``metric`` (``Mrays_<config>``), ``value`` (the best rep's
Mrays/s), ``unit``, ``spp``, ``depth``, ``resolution``, the gate's
``rmse_vs_oracle_<crop>x<crop>_<spp>spp`` and, over more than one rep,
``median_mrays``, ``reps`` and ``rep_s`` (min, median, max seconds), as in
bench.py.  Rays are counted as ``render_image`` counts them: camera, bounce,
NEE shadow and MIS pdf-probe rays.  bench.py's ``vs_baseline`` (the ratio to
a 150 Mrays/s target set for the TPU) is left out.  Added here: ``rays`` of
one frame, ``times_s`` (every rep), ``launches`` (each kernel's launches in
the last rep, ``{"dense": {...}, "traverse": {...}, "graphs": {"loop_cond": n}}``), that rep's
``bands``, ``waves`` and ``peak_memory_bytes``, ``graphs_captured`` (per
rep: 0), and the set-up apart from
the reps: ``upload_s`` (building and uploading the scene), ``gate_s`` and
``warm_s``.  The summary adds ``kernel_build_s``.

Schedule (bench.py:281-312): cfg1 takes 3 reps up front and 1 after every
other config's first rep, the other reps run round-robin, and cfg1's last
reps come last; ``VKRT_BENCH_BUDGET`` (seconds, default 2200) is a soft
deadline that trims reps, never configs or gates.  Every line prints at the
end, after the card's name and power limit as nvidia-smi reads them: the
configs 2-5, the summary, then cfg1.  Progress and the package's log lines
go to stderr.

Gates: before its reps, each config renders its small crop through the same
``render_image`` dispatch on the card and holds it against a committed oracle
golden: RMSE < 2e-3, under a scene and camera fingerprint that must match.
cfg2-cfg5 (and cfg1 of the glTF) read ``bench_goldens.npz``
(``tools/gen_bench_goldens.py``), cfg1 of the built-in box reads
``bench_goldens_torch.npz`` (``tools/gen_torch_bench_goldens.py``).

Warm-up: the kernels build on first use (``ops/_ext.py``), then each
config renders its whole frame once: the CUDA context and the caching
allocator warm up, and the program of every wave shape a frame launches
(``render/graphs.py``: a wave is one captured program whose loops run on
the card) is captured there.  A ragged last band is a wave shape of its
own, so a band alone (bench.py's warm-up for banded configs) could leave a
program for the reps to capture.  A rep that captured a program ends the
run nonzero.

There is no fallback: without CUDA the bench exits nonzero before it renders
anything; a missing or stale golden, a gate above its bar, an all-black
frame, a config whose reps do not launch its kernels (K1-K3 for cfg1;
K5' closest and shadow and K3 for the BVH scenes), or a rep that captured
a graph ends the run nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .cli import _render_fingerprint
from .ops import _ext
from .render import graphs, renderer
from .render.integrator import launch_counts, reset_counters
from .scene import procedural
from .scene.builtin import cornell_box_scene
from .scene.camera import Camera
from .scene.scenegraph import Scene

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "bench_goldens.npz"
GOLDENS_TORCH = ROOT / "bench_goldens_torch.npz"
BUDGET = float(os.environ.get("VKRT_BENCH_BUDGET", "2200"))
RMSE_BAR = 2e-3
_T0 = time.monotonic()

#: the kernels each kind of config must launch in every rep, as (module,
#: counter) of :func:`launch_counts`
DENSE_KERNELS = (("dense", "closest"), ("dense", "shadow"), ("dense", "pdf"))  # K1, K2, K3
BVH_KERNELS = (("traverse", "treelet_closest"), ("traverse", "treelet_shadow"),
               ("dense", "pdf"))  # K5', K3


def _elapsed() -> float:
    return time.monotonic() - _T0


def _mark(msg: str) -> None:
    """Progress to stderr."""
    print(f"[bench +{_elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)


def _cam(pos, d) -> Camera:
    return Camera(position=np.array(pos, np.float64), direction=np.array(d, np.float64))


def _hall_sky() -> Scene:
    s = procedural.hall_scene()
    s.skybox = procedural.sky_hdr()
    s.skybox_strength = 1.0
    return s


# (key, scene, cam, w, h, spp, depth, crop=(cw, cspp, cdepth), reps,
# kernels); bench.py:131-152 (its warm-up modes aside).  Order: 2..5 first, cfg1 last.
CONFIGS = [
    dict(key="cfg2_dragon_substitute_262k_512x512_d4", build=procedural.dragon_scene,
         cam=([0.0, 2.2, 4.5], [0.0, -0.25, -1.0]),
         w=512, h=512, spp=4, depth=4, crop=(16, 2, 3), reps=3,
         kernels=BVH_KERNELS),
    dict(key="cfg3_chess_substitute_98k_512x512_d6", build=procedural.chess_scene,
         cam=([0.0, 4.0, 7.0], [0.0, -0.5, -1.0]),
         w=512, h=512, spp=4, depth=6, crop=(16, 2, 4), reps=3,
         kernels=BVH_KERNELS),
    dict(key="cfg4_sponza_substitute_256k_hdrsky_960x540_d4_8spp", build=_hall_sky,
         cam=([-9.0, 1.8, 0.0], [1.0, 0.0, 0.0]),
         w=960, h=540, spp=8, depth=4, crop=(16, 2, 3), reps=3,
         kernels=BVH_KERNELS),
    dict(key="cfg5_multimodel_1920x1080_d8_8spp", build=procedural.multi_scene,
         cam=([-9.0, 2.0, 1.5], [1.0, -0.1, -0.15]),
         w=1920, h=1080, spp=8, depth=8, crop=(12, 1, 4), reps=2,
         kernels=BVH_KERNELS),
    dict(key="cfg1_cornell_{src}_512x512_d4_64spp", build=cornell_box_scene,
         cam=([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
         w=512, h=512, spp=64, depth=4, crop=(48, 4, 3), reps=9,
         kernels=DENSE_KERNELS),
]


def cornell_config(gltf=None) -> dict:
    """cfg1 with its scene source settled: the built-in box, gated on
    ``bench_goldens_torch.npz``, or the glTF at ``gltf`` (bench.py:89-98),
    gated on ``bench_goldens.npz``'s cfg1 golden, stored under the unformatted
    key."""
    cfg = CONFIGS[-1]
    if gltf is None:
        key = cfg["key"].format(src="builtin")
        return dict(cfg, key=key, gate=key)

    def build() -> Scene:
        s = Scene()
        s.load_model(Path(gltf))
        return s

    return dict(cfg, key=cfg["key"].format(src="refgltf"), gate=cfg["key"], build=build)


def gate_fingerprint(tables, cam, cw, cspp, cdepth) -> str:
    """Scene, camera and crop digest that must match the stored golden's
    (bench.py:155-159: the JAX CLI's digest, then the crop's spp)."""
    return _render_fingerprint(tables, cam, cw, cw, cdepth, True) + f":{cspp}"


def load_goldens() -> dict:
    """Every committed gate golden: bench.py's file, then this port's."""
    out = {}
    for path in (GOLDENS, GOLDENS_TORCH):
        if path.exists():
            with np.load(path, allow_pickle=False) as f:
                out.update({k: f[k] for k in f.files})
    return out


def quality_gate(key, tables, cam, crop, goldens, bar=RMSE_BAR) -> float:
    """The crop's per-pixel RMSE against its committed oracle golden
    (bench.py:162-186), rendered through the same ``render_image`` dispatch
    as the timed frame, on the tables' device."""
    cw, cspp, cdepth = crop
    gkey, fkey = f"golden_{key}", f"fp_{key}"
    if gkey not in goldens:
        raise SystemExit(f"{key}: no committed golden - run tools/gen_bench_goldens.py "
                         "(cfg2-cfg5) or tools/gen_torch_bench_goldens.py (the built-in cfg1)")
    fp = gate_fingerprint(tables, cam, cw, cspp, cdepth)
    if str(goldens[fkey]) != fp:
        raise SystemExit(f"{key}: golden fingerprint stale ({goldens[fkey]} != {fp}) - "
                         "the scene, camera or gate changed; regenerate the golden")
    img, _ = renderer.render_image(tables, cam, cw, cw, spp=cspp, max_depth=cdepth,
                                   tonemap=False)
    golden = goldens[gkey]
    rmse = float(np.sqrt(np.mean((img - golden) ** 2))) if img.shape == golden.shape else np.inf
    if not rmse < bar:  # NaN fails too
        raise SystemExit(f"{key}: RMSE {rmse} vs the oracle golden is not below {bar}")
    return rmse


class _Cfg:
    """One prepared config: its scene uploaded, its gate passed, warm."""

    def __init__(self, cfg, goldens, device, reps=None):
        self.cfg = cfg
        self.reps = cfg["reps"] if reps is None else min(cfg["reps"], reps)
        self.key = cfg["key"]
        self.times = []
        self.captured = []  # graphs each rep captured
        self.rays = 0
        self.last = {}
        _mark(f"{self.key}: upload+gate+warm-up")
        self._prepare(goldens, device)

    def _prepare(self, goldens, device) -> None:
        """Upload the scene, pass the gate and warm up, each timed."""
        cfg = self.cfg
        t0 = time.perf_counter()
        self.tables = cfg["build"]().upload(device)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self.upload_s = t1 - t0
        self.cam = _cam(*cfg["cam"])
        cw, cspp, _ = cfg["crop"]
        self.rmse = quality_gate(cfg.get("gate", self.key), self.tables, self.cam, cfg["crop"],
                                 goldens)
        self.rmse_key = f"rmse_vs_oracle_{cw}x{cw}_{cspp}spp"
        t2 = time.perf_counter()
        self.gate_s = t2 - t1
        img, _ = renderer.render_image(self.tables, self.cam, cfg["w"], cfg["h"],
                                       spp=cfg["spp"], max_depth=cfg["depth"], as_uint8=True)
        if not img.any():
            raise SystemExit(f"{self.key}: all-black warm-up")
        torch.cuda.synchronize(device)
        self.warm_s = time.perf_counter() - t2

    def rep(self, n=1) -> None:
        for _ in range(n):
            if len(self.times) >= self.reps:
                return
            if self.times and _elapsed() + min(self.times) > BUDGET:
                return  # the soft deadline trims reps, never configs or gates
            self._timed_render()

    def _timed_render(self) -> None:
        """One frame, timed from an idle card to the image on the host; its
        kernel launches counted from zero."""
        cfg = self.cfg
        reset_counters()
        graphs.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = renderer.render_image(self.tables, self.cam, cfg["w"], cfg["h"],
                                          spp=cfg["spp"], max_depth=cfg["depth"],
                                          as_uint8=True)
        torch.cuda.synchronize()  # the copy to the host has already waited for the card
        self.times.append(time.perf_counter() - t0)
        launches = launch_counts()
        if not img.any():
            raise SystemExit(f"{self.key}: all-black render")
        missing = [f"{mod}.{k}" for mod, k in cfg["kernels"] if not launches[mod][k]]
        if missing:
            raise SystemExit(f"{self.key}: the render launched no {missing} (launches {launches})")
        self.captured.append(graphs.STATS["captured"])
        if self.captured[-1]:
            raise SystemExit(f"{self.key}: rep {len(self.times)} captured "
                             f"{self.captured[-1]} graphs the warm-up frame did not")
        self.rays = rays
        self.last = {"launches": launches, **renderer.LAST_RENDER,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    def line(self) -> dict:
        cfg = self.cfg
        dt = min(self.times)
        mrays = self.rays / dt / 1e6
        line = {
            "metric": f"Mrays_{self.key}",
            "value": round(mrays, 3),
            "unit": "Mrays/s",
            "spp": cfg["spp"],
            "depth": cfg["depth"],
            "resolution": f"{cfg['w']}x{cfg['h']}",
            self.rmse_key: round(self.rmse, 9),
        }
        if len(self.times) > 1:
            med = float(np.median(self.times))
            line["median_mrays"] = round(self.rays / med / 1e6, 3)
            line["reps"] = len(self.times)
            line["rep_s"] = [round(t, 2) for t in (min(self.times), med, max(self.times))]
        line.update(rays=self.rays, times_s=self.times, graphs_captured=self.captured,
                    **self.last, upload_s=self.upload_s,
                    gate_s=self.gate_s, warm_s=self.warm_s)
        return line


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _setup(device) -> float:
    """Build (or load) the kernels and open the CUDA context; returns the
    seconds it took."""
    t0 = time.perf_counter()
    _ext.library()
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def run(device, reps=None, cornell_gltf=None):
    """Prepare every config and run bench.py's schedule; ``reps`` caps each
    config's reps (``chip_smoke.py`` runs one), ``cornell_gltf`` is cfg1's
    glTF (None: the built-in box).  Returns (configs 2-5, cfg1, the summary
    line, which carries ``kernel_build_s``)."""
    build_s = _setup(device)
    goldens = load_goldens()
    summary = {"metric": "bench_summary", "unit": "Mrays/s"}

    # cfg1 first: its reps spread over the whole run, so one slow window
    # cannot depress every sample (its line still prints last)
    c1 = _Cfg(cornell_config(cornell_gltf), goldens, device, reps)
    c1.rep(3)

    others = []
    for cfg in CONFIGS[:-1]:
        c = _Cfg(cfg, goldens, device, reps)
        _mark(f"{c.key}: first timed rep")
        c.rep(1)
        others.append(c)
        c1.rep(1)

    # round-robin the remaining reps: a slow window covers at most one rep
    # of each config
    extra_passes = max(c.reps for c in others) - 1
    for p in range(extra_passes):
        _mark(f"round-robin rep pass {p + 2}")
        for c in others:
            if len(c.times) < c.reps:
                c.rep(1)
        c1.rep(1)

    _mark("cfg1: final reps")
    c1.rep(max(c1.reps - len(c1.times), 0))

    for c in others:
        summary[c.key] = c.line()["value"]
    line = c1.line()
    summary[c1.key] = line["value"]
    summary["cfg1_median"] = line.get("median_mrays", line["value"])
    summary["kernel_build_s"] = build_s
    summary["wall_s"] = round(_elapsed(), 1)
    return others, c1, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cornell-gltf", default=None, metavar="PATH",
                   help="cfg1 renders this glTF (the reference renderer's res/CornellBox.gltf, "
                        "gated on bench_goldens.npz) instead of the built-in Cornell box")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"vulkan_raytracer_tpu_torch.bench: CUDA is not available (torch "
                         f"{torch.__version__}); the bench renders on an NVIDIA card only")
    # the package's log lines go to stderr with the progress: stdout holds
    # the result lines only
    with contextlib.redirect_stdout(sys.stderr):
        others, c1, summary = run(torch.device("cuda", 0), cornell_gltf=args.cornell_gltf)
    # every line prints together at the end: a bounded tail capture holds
    # all of them or none; the summary precedes cfg1's headline
    print(nvidia_smi_line(), flush=True)
    for c in others:
        print(json.dumps(c.line()), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps(c1.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
