#!/usr/bin/env python3
"""The dense sweeps K1-K3 on the card, at the launches the renders make.

    python3 tools/bench_torch_dense.py [--root DIR] [--reps 20] [--waves cfg1,textured,gltf]
                                       [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.  For each
of cfg1 (the built-in Cornell box), the textured glb and the
147,136-triangle glTF (written by tools/torch_glb_assets.py), it renders the
first wave of its 512x512, depth-4 render (524,288 lanes: samples 1-2 of every
pixel, or for the glTF its first band of 131,072 pixels x 4 samples;
tools/profile_torch_wave.py) with every dense sweep call recorded
(``chip_smoke.record_wave``: the inputs and the result, cloned).  Each
recorded call is then replayed ``--reps`` times under torch.profiler, which
gives the kernel's own device time per launch, and reported with its live
lanes (K1 t_init > t_lo, K2 t_hi > 0, K3 gate != 0) and its bound
(``chip_smoke.sweep_work``); the replayed result must equal the recorded one.
A last line times K1-K3 on the synthetic cfg1 wave of
``chip_smoke.time_kernels`` (524,288 random rays in the Cornell box, 80%
active) with ``chip_smoke.time_launch``: device time and the wrapper's host
microseconds per call.
Then a line for K2 on sparse launches (:func:`shadow_sparse_line`): the
occlusion sweep over the Cornell box (36 triangles), a 1,000-triangle and a
20,000-triangle soup with one lane, 0.1%, 5%, 50% and all of 524,288 lanes
live (``chip_smoke.live_mask``; the 20,000-triangle table only up to 5%),
device time per launch and a digest of the flags: the launches on which the
kernel's choice between a thread and a warp per ray is made.
``--reps 0`` records, counts and checks without timing.  ``--waves`` limits
the recorded renders (K2 runs only in cfg1's).

``--root DIR`` runs the ``vulkan_raytracer_tpu_torch`` package of another
checkout (for example an unpacked earlier commit), which renders the waves
and launches the kernels; so one call can time two versions in turns.  Each
line carries the dense kernels' ptxas figures and digests of the recorded
inputs and of the results (K1 t and triangle, K2 occlusion, K3 the pdf on
lanes whose gate is not 0), which two versions must share.  It prints one
JSON line per wave (and writes them to ``--out`` if given).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WAVES = ("cfg1", "textured", "gltf")  # tools/profile_torch_wave.py CONFIGS


def _smoke():
    """This checkout's chip_smoke.py, whichever package is imported."""
    spec = importlib.util.spec_from_file_location("_bench_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)
    else:
        yield torch.tensor(x)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def compared(kernel: str, args, result):
    """The part of a sweep's result that two versions must share: the pdf
    only where the gate is not 0 (elsewhere the contract allows +0 or pdf*0)."""
    if kernel == "dense_emissive_pdf":
        return (result[args[2] != 0.0],)
    return tuple(_tensors(result))


def wave_summary(cs, calls, reps: int) -> dict:
    """Each recorded call's live lanes, bound and, if ``reps``, device time;
    each kernel's totals over the wave; and the digests.  Replays every call
    and raises if its result differs from the recorded one."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    sweeps = [functools.partial(getattr(dense, cs.DENSE_SWEEPS[k]), *a) for k, a, _ in calls]
    outputs = []
    for i, ((kernel, args, recorded), sweep) in enumerate(zip(calls, sweeps)):
        got, want = compared(kernel, args, sweep()), compared(kernel, args, recorded)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"call {i} ({kernel}) replays to another result")
        outputs.extend(got)
    launches = [{"kernel": k, **cs.sweep_work(k, a)} for k, a, _ in calls]
    if reps:
        trace = {v: k for k, v in cs._ENTRIES.items()}
        for entry, sweep, (kernel, _, _) in zip(launches, sweeps, calls):
            entry["ms"], entry["launches_traced"] = cs.device_ms(sweep, trace[kernel], reps)
    totals = {}
    for e in launches:
        t = totals.setdefault(e["kernel"], {"launches": 0, "live": 0, "bound_ms": 0.0})
        t["launches"] += 1
        t["live"] += e["live"]
        t["bound_ms"] += e["bound_ms"]
        if reps:
            t["ms"] = t.get("ms", 0.0) + e["ms"]
    return {"per_kernel": totals, "launches": launches,
            "digest_inputs": _digest(x for _, a, _ in calls for x in _tensors(a)),
            "digest_outputs": _digest(outputs)}


def synthetic_line(cs, device, reps: int) -> dict:
    """K1-K3 on chip_smoke.time_kernels' synthetic cfg1 wave."""
    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    calls = cs.cfg1_launches(cornell_box_scene().upload(device), 2 * 512 * 512, device)
    out = {"digest_inputs": _digest(x for _, a in calls for x in _tensors(a)),
           "digest_outputs": _digest(
               x for k, a in calls
               for x in compared(k, a, getattr(dense, cs.DENSE_SWEEPS[k])(*a)))}
    shape = "synthetic cfg1 wave: 524,288 rays, 80% active"
    for kernel, args in calls:
        out[kernel] = (cs.time_launch(kernel, args, shape, reps=reps) if reps
                       else cs.sweep_work(kernel, args))
    return out


def shadow_sparse_line(cs, device, reps: int, n: int = 2 * 512 * 512) -> dict:
    """K2 at sparse launches over short and long tables: per table and live
    share, the live lanes, the occluded lanes and, if ``reps``, the device
    time per launch; one digest over every launch's flags."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    rays = cs.make_rays(n, seed=41, device=device)
    cols = dense.ray_columns(rays["o"], rays["d"])
    scenes = {"cornell": (cornell_box_scene(), ("one", 0.001, 0.05, 0.5, 1.0)),
              "soup1000": (cs.soup_scene(1000, seed=7), ("one", 0.001, 0.05, 0.5, 1.0)),
              "soup20000": (cs.soup_scene(20000, seed=17), ("one", 0.001, 0.05))}
    out, flags = {}, []
    for name, (scene, shares) in scenes.items():
        table = scene.upload(device).tri_table
        out[name] = {}
        for share in shares:
            live = torch.as_tensor(cs.live_mask(n, share, seed=5), device=device)
            t_hi = torch.where(live, rays["t_shadow"], 0.0).contiguous()
            occ = dense.shadow_sweep(table, cols, t_hi)
            flags.append(occ)
            entry = {"live": int(live.sum()), "occluded": int(occ.sum())}
            if reps:
                entry["ms"], entry["launches_traced"] = cs.device_ms(
                    functools.partial(dense.shadow_sweep, table, cols, t_hi), "shadow_kernel",
                    reps)
            out[name][str(share)] = entry
    return {"by_table": out, "digest_outputs": _digest(flags)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="checkout whose vulkan_raytracer_tpu_torch package runs")
    p.add_argument("--reps", type=int, default=20, help="launches per timed call; 0: no timing")
    p.add_argument("--waves", default=",".join(WAVES),
                   help="comma-separated renders to record (default: all)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    waves = [w for w in args.waves.split(",") if w]
    if not set(waves) <= set(WAVES):
        p.error(f"--waves takes a subset of {WAVES}")
    pkg_root = Path(args.root).resolve()
    sys.path[:0] = [str(pkg_root), str(ROOT / "tools")]
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_dense.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    cs = _smoke()

    import profile_torch_wave

    from vulkan_raytracer_tpu_torch.ops import _ext, dense

    if not Path(dense.__file__).resolve().is_relative_to(pkg_root):
        raise RuntimeError(f"imported {dense.__file__}, not the package under {pkg_root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    ptxas = {k: v for k, v in cs.ptxas_table(_ext.ptxas_report()).items()
             if k.startswith("dense")}
    device = torch.device("cuda", 0)
    head = {"root": str(pkg_root), "nvidia_smi": smi, "reps": args.reps, "ptxas": ptxas}
    lines = []
    for config in waves:
        scene, pos, direction = profile_torch_wave.CONFIGS[config]
        tables = profile_torch_wave._scene(scene).upload(device)
        spp = profile_torch_wave.FRAMES[config][2]
        calls = cs.record_wave(tables, (pos, direction), spp=spp)
        lines.append(json.dumps({**head, "config": f"{config}: the first wave of 512x512 at "
                                                   f"{spp} spp",
                                 **wave_summary(cs, calls, args.reps)}))
        print(lines[-1], flush=True)
        del tables, calls
        torch.cuda.empty_cache()
    lines.append(json.dumps({**head, "config": "synthetic cfg1",
                             **synthetic_line(cs, device, args.reps)}))
    print(lines[-1], flush=True)
    lines.append(json.dumps({**head, "config": "K2 sparse launches",
                             **shadow_sparse_line(cs, device, args.reps)}))
    print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
