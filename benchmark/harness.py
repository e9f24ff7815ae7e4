"""One run of one cell: set-up, the window, the output comparison, the
result line.

The set-up builds the cell's scene from its own frozen generator, hands it
to the port (``Scene.add_raw_mesh``, ``Scene.upload``), and renders the
traffic's warm frames, which capture every program the window launches.
The window then renders whole frames back to back, one client in a closed
loop, until ``--seconds`` have passed: ``render_image(..., as_uint8=True)``
in a batch mix, ``Renderer.draw_frame(pipeline=True)`` in a progressive
one.  With ``--trace 1`` the window is the traffic's ``trace_frames``
frames under ``torch.profiler`` instead, and only per-layer metrics are
reported.  Once the window has closed and the peak memory is read, the
program's state goes, and the reference renders the pixels the seed picked
of the frames the seed picked, at the same samples, on the same card.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import camera as cam_math
from benchmark import compare, trace, window
from benchmark.reference import pathtracer
from benchmark.spec import Spec

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "vulkan_raytracer_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def port_scene(data):
    """The port's ``Scene`` of the scene's arrays: each mesh through
    ``add_raw_mesh``, a material made once per material of the arrays."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Scene

    scene, made = Scene(), {}
    for mesh in data.meshes:
        mat = made.get(id(mesh.material))
        if mat is None:
            mat = made[id(mesh.material)] = Material()
            for key, value in vars(mesh.material).items():
                setattr(mat, key, value)
        scene.add_raw_mesh(mesh.positions, mesh.normals, mesh.indices, mat, mesh.transform)
    if data.skybox is not None:
        scene.skybox = data.skybox
    scene.skybox_strength = data.skybox_strength
    return scene


def seeded(seed: int, config: dict, traffic: dict) -> dict:
    """What the seed picks, without changing a shape: the camera moved by
    up to ``camera_jitter`` on each axis, a batch frame's first sample,
    the pixels the comparison reads, and the stream that picks the frames
    it reads."""
    rng = np.random.default_rng(seed % (1 << 63))
    cams = config.get("cameras", {})
    view = cams.get(traffic["mode"], config["camera"])
    jitter = float(config.get("camera_jitter", 0.0))
    position = np.asarray(view["position"], np.float64) + rng.uniform(-jitter, jitter, 3)
    first = 1 + int(rng.integers(0, 1 << 24))
    pixels = np.sort(rng.choice(traffic["width"] * traffic["height"],
                                traffic["check_pixels"], replace=False))
    return dict(position=position, direction=np.asarray(view["direction"], np.float64),
                first=first, pixels=pixels, rng=rng)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Kept:
    """The frames the comparison reads: the last and, where ``every`` (a
    batch mix: each frame is an answer of its own), also the first and
    one drawn uniformly by the seed (a reservoir of one).  Each is (frame
    index, its sample number, its pixels' uint8 values)."""

    def __init__(self, rng, pixels, every: bool):
        self.rng, self.pixels, self.every = rng, pixels, every
        self.first = self.drawn = self.last = None
        self.seen = 0

    def offer(self, index: int, sample: int, image: np.ndarray) -> None:
        flat = image.reshape(-1, 3)
        entry = None
        if self.every and (self.first is None
                           or self.rng.random() * (self.seen + 1) < 1.0):
            entry = (index, sample, flat[self.pixels].copy())
        if self.first is None:
            self.first = entry
        elif entry is not None:
            self.drawn = entry
        self.last = (index, sample, image)
        self.seen += 1

    def frames(self) -> list:
        index, sample, image = self.last
        last = (index, sample, image.reshape(-1, 3)[self.pixels].copy())
        out = {e[0]: e for e in (self.first, self.drawn, last) if e is not None}
        return [out[k] for k in sorted(out)]


def run(workload: str, seed: int, seconds: float, traced: bool, *, root=None,
        device: str = "cuda", started: float | None = None, log=None) -> dict:
    """Run one cell; returns the result line's object.  ``device`` other
    than ``"cuda"`` is for the CPU tests of the harness (no chip check, no
    profiler)."""
    started = time.perf_counter() if started is None else started
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = Spec(root) if root is not None else Spec()
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(0)
        torch.cuda.init()
        if traced:
            # CUPTI misses reruns of a conditional body's nodes in programs
            # instantiated before the first profiler session: open one first
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.zeros(1, device=dev).add_(1)
            _sync(dev)

    from vulkan_raytracer_tpu_torch.render import graphs, integrator, renderer
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    pick = seeded(seed, config, traffic)
    mode, width, height = traffic["mode"], traffic["width"], traffic["height"]
    spp, depth = traffic.get("spp", 1), traffic["depth"]
    record = {"mode": mode, "spans": {}}
    spans = record["spans"]

    t = time.perf_counter()
    data = spec.scene_builder(config)(**config.get("scene_args", {}))
    spans["scene_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tables = port_scene(data).upload(dev)
    _sync(dev)
    spans["upload_s"] = time.perf_counter() - t

    camera = Camera(position=pick["position"].copy(), direction=pick["direction"].copy())
    graphs.reset_stats()
    t = time.perf_counter()
    if mode == "batch":
        for i in range(traffic["warm_frames"]):
            renderer.render_image(tables, camera, width, height, spp, depth,
                                  start_sample=pick["first"], as_uint8=True)
    elif mode == "progressive":
        warm = renderer.Renderer(tables, camera, width, height, depth)
        for i in range(traffic["warm_frames"]):
            warm.draw_frame(pipeline=True)
        del warm  # its frame state goes back to the pool, programs and all
        gc.collect()
    else:
        raise RunError(f"unknown traffic mode {mode!r}")
    _sync(dev)
    spans["warm_s"] = time.perf_counter() - t
    record["capture_s"] = graphs.STATS["capture_s"]
    graphs.settle()
    integrator.reset_counters()
    graphs.reset_stats()

    kept = _Kept(pick["rng"], pick["pixels"], every=mode == "batch")
    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    frames, calls, intervals = 0, 0, []
    window_start = time.perf_counter()
    setup_s = window_start - started
    if mode == "batch":
        while True:
            first = pick["first"] + frames * spp
            with torch.profiler.record_function("render_image"):
                image, _ = renderer.render_image(tables, camera, width, height, spp, depth,
                                                 start_sample=first, as_uint8=True)
            now = time.perf_counter()
            kept.offer(frames, first, image)
            frames += 1
            if (frames >= traffic["trace_frames"]) if traced else (now - window_start >= seconds):
                break
        window_end = now
    else:
        player = renderer.Renderer(tables, camera, width, height, depth)
        last = None
        while True:
            with torch.profiler.record_function("draw_frame"):
                image = player.draw_frame(pipeline=True)
            now = time.perf_counter()
            calls += 1
            if image is not None:
                # a pipelined call hands out the frame before its own: the
                # first call's frame is the preview (sample 0)
                if last is not None:
                    intervals.append(now - last)
                last = now
                kept.offer(frames, calls - 2, image)
                frames += 1
            done = (calls >= traffic["trace_frames"]) if traced else (now - window_start >= seconds)
            if done and frames >= 2 and calls >= 3:
                break
        window_end = now
    _sync(dev)
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = window_end - window_start
    graphs.settle()
    captured = graphs.STATS["captured"]
    # the frames rendered: a pipelined call renders one more than it hands out
    rendered = calls if mode == "progressive" else frames
    record.update(frames=frames, rendered=rendered, window_s=window_s, intervals=intervals,
                  setup_s=setup_s, pixels=width * height, spp=spp,
                  program_launches=graphs.STATS["launches"],
                  bounce_widths=dict(integrator.BOUNCE_WIDTHS),
                  launch_counts=integrator.launch_counts())
    if captured:
        raise RunError(f"the window captured {captured} programs: its shapes were not warmed")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type

    if prof is not None:
        _read_trace(prof, record)
    del prof

    # the program's state goes before the reference runs
    player = None
    del tables, player
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log(f"setup_s {setup_s:.3f} spans {json.dumps(spans)} capture_s {record['capture_s']:.3f}"
        f" frames {frames} window_s {window_s:.3f} memory_peak_bytes {peak}")
    t = time.perf_counter()
    checks = check(data, pick, traffic, kept.frames(), mode, dev)
    log(f"reference_s {time.perf_counter() - t:.3f}")
    worst = max(c["u8_mean_abs"] for c in checks)
    limit = limits["u8_mean_abs"]
    failed = sum(c["u8_mean_abs"] > limit for c in checks)
    for c in checks:
        log(f"check frame {c['frame']} (samples {c['first']}..{c['first'] + c['count'] - 1}): "
            f"u8_mean_abs {c['u8_mean_abs']:.6g} limit {limit}")

    metrics = {}
    entries = spec.per_layer(workload) if traced else spec.end_to_end(workload)
    for m in entries:
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": failed == 0,
        "attempted": frames,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced and "busy_s" in record:
        result["device"].update(busy_s=record["busy_s"], window_s=record["trace_window_s"])
        result["breakdown"] = record["breakdown"]
    result["checks"] = {"u8_mean_abs": {"value": worst, "limit": limit}}
    return result


def check(data, pick, traffic, frames, mode, dev) -> list:
    """Each kept frame's pixels against the reference's at the same
    samples: a batch frame's ``spp`` from its first, a progressive frame's
    mean of samples 1..its own."""
    scene = pathtracer.RefScene(data, dev)
    width, height, depth = traffic["width"], traffic["height"], traffic["depth"]
    view_inv, proj_inv = cam_math.matrices(pick["position"], pick["direction"], width, height)
    pixels = torch.as_tensor(pick["pixels"], device=dev)
    out = []
    for index, sample, values in frames:
        if mode == "batch":
            first, count = sample, traffic["spp"]
        else:
            if sample < 1:
                raise RunError("the window handed out no frame past the preview")
            first, count = 1, sample
        mean = pathtracer.pixel_means(scene, view_inv, proj_inv, width, height, pixels, first,
                                      count, depth)
        ref = pathtracer.tonemap_u8(mean).cpu().numpy()
        out.append(dict(frame=index, first=first, count=count,
                        u8_mean_abs=compare.u8_mean_abs(values, ref)))
    return out


def _read_trace(prof, record) -> None:
    """The traced window's device numbers into ``record``; the launches
    the trace saw and those the port counted on a line of their own."""
    import vulkan_raytracer_tpu_torch

    events = trace.device_events(prof)
    hosts = trace.host_events(prof)
    sources = trace.kernel_sources(Path(vulkan_raytracer_tpu_torch.__file__).parent / "csrc")
    record["kernel_seconds"] = trace.seconds_by_source(events, sources)
    if events:
        t0 = min(s for _, s, _ in events + hosts)
        t1 = max(e for _, _, e in events + hosts)
        record["busy_s"] = window.union_seconds([(s, e) for _, s, e in events])
        record["trace_window_s"] = t1 - t0
        record["breakdown"] = {"device_ops": trace.top_ops(events),
                               "idle_gaps": trace.idle_gaps(events, hosts, t0, t1)}
    traced = trace.launches(events, sources)
    counted = trace.counted(record["launch_counts"])
    print(json.dumps({"traced_launches": traced, "counted_launches": counted,
                      "agree": traced == counted,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                      "card": _card()}), flush=True)


def _card() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None, started: float | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
    except RunError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
