#!/usr/bin/env python3
"""The emissive-pdf walk on the card: the synthetic launch and every probe
launch of one emitter-soup wave.

    python3 tools/bench_torch_emissive.py [--root DIR] [--reps 10] [--plain] [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA card.

1. The synthetic launch of ``chip_smoke.py``'s phase 14: the stream of
   ``chip_smoke.soup_scene(20000, seed=17)`` (20,000 emissive triangles),
   524,288 random rays in the Cornell volume (``chip_smoke.make_rays``, seed
   99: 80% of the lanes live), t_min EPS; then the same rays at each share
   of ``chip_smoke.LIVE_SHARES`` (``chip_smoke.live_mask``).
2. Every probe launch of one emitter-soup wave:
   ``chip_smoke.emitter_soup_scene(100000, 5000, seed=31)``, 512x512, depth
   4, 4 spp, cfg1's camera, the first wave ``render_image`` runs (a band of
   131,072 pixels x 4 samples), rendered once eagerly with each call of the
   walk's inputs kept (``chip_smoke.record_emissive_probes``).  Each launch
   has its t_min (EPS: the MIS probe, 0: the NEE probe), its live lanes and
   live 128-lane blocks (the first kernel's blocks).

Each launch is timed on the device (``check_torch_trace._cold_ms`` with one
copy: ``--reps`` launches on the same inputs in one captured graph, so the
wrapper's host time is not counted; the inputs, ~15 MB, stay in L2, as the
wave's do), and
carries a digest of its output, which two versions of the kernel must
share.  With ``--plain`` each launch is also held against the plain version
(``emissive_pdf_walk_reference``; the line says whether they are bit-equal
on active lanes) and carries the bound of its work: ``emissive_walk_visits``
on the binary tree, ``chip_smoke.emissive_walk_bound`` (operations at 67
TFLOP/s, bytes at 3.35 TB/s).

``--root DIR`` walks with the ``vulkan_raytracer_tpu_torch`` package of
another checkout (an unpacked earlier commit) over the same scenes and rays,
so one call can time two versions in turns.  One JSON line a launch, then a
summary line (the sum of the wave's launches); the nvidia-smi line first.
It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 128  # lanes a block of the first kernel


def _smoke():
    """This checkout's chip_smoke.py, whichever package is imported."""
    spec = importlib.util.spec_from_file_location("_emissive_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(x) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def _live_blocks(active) -> int:
    import torch

    pad = (-active.shape[0]) % BLOCK
    return int(torch.nn.functional.pad(active, (0, pad)).view(-1, BLOCK).any(1).sum())


def measure(cs, stream, cols, active, t_min: float, reps: int, plain: bool) -> dict:
    """One launch's line: live lanes and blocks, µs, digest; with ``plain``
    bit-equality to the plain version and the bound."""
    from check_torch_trace import _cold_ms

    from vulkan_raytracer_tpu_torch.ops import traverse as tr

    out = tr.emissive_pdf_walk(stream, cols, active, t_min)
    line = {"t_min": t_min, "lanes": int(active.shape[0]), "live": int(active.sum()),
            "live_blocks": _live_blocks(active),
            "us": 1e3 * _cold_ms(lambda: tr.emissive_pdf_walk(stream, cols, active, t_min),
                                 [()], reps),
            "digest": _digest(out)}
    if plain:
        want = tr.emissive_pdf_walk_reference(stream, cols, active, t_min)
        b, v = cs.emissive_walk_bound(stream, cols, active, t_min)
        line.update(bit_equal=bool(out[active].equal(want[active])),
                    zero_off=bool((out[~active] == 0).all()), bound_us=1e3 * b["bound_ms"],
                    bound_by=b["bound_by"], node_tests=int(v["nodes"].sum()),
                    tri_tests=int(v["tris"].sum()), hits=int(v["hits"].sum()))
    return line


def record_wave(cs, device):
    """The emitter soup's tables and the kept inputs of every probe launch
    of its first wave: [(t_min, live lanes, ray columns, active)]."""
    import numpy as np
    from profile_torch_wave import first_wave, wave

    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    tables = cs.emitter_soup_scene(100000, 5000, seed=31).upload(device)
    camera = Camera(position=np.array(cs.CFG1_CAM[0]), direction=np.array(cs.CFG1_CAM[1]),
                    aspect=1.0)
    lanes, samples, _ = first_wave(tables, 512, 512, 4)
    _, probes = cs.record_emissive_probes(wave(tables, camera, 512, 512, 4, lanes, samples))
    return tables, probes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="checkout whose vulkan_raytracer_tpu_torch package is timed")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--plain", action="store_true",
                   help="hold each launch against the plain version and give its bound")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(Path(args.root).resolve()))
    os.environ.setdefault("VKRT_LOG_LEVEL", "WARN")
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_emissive.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    cs = _smoke()
    from vulkan_raytracer_tpu_torch.ops import dense

    device = torch.device("cuda", 0)
    lines = [{"nvidia_smi": cs.nvidia_smi_line(), "root": str(Path(args.root).resolve())}]

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    print(json.dumps(lines[0]), flush=True)
    soup = cs.soup_scene(20000, seed=17).upload(device)
    stream = soup.em_stream
    n = 2 * 512 * 512
    rays = cs.make_rays(n, seed=99, device=device)
    cols = dense.ray_columns(rays["o"], rays["d"])
    emit({"mode": "synthetic", "share": "rays' own (80%)", "stream_bytes": stream.nbytes,
          **measure(cs, stream, cols, rays["active"], cs.EPS, args.reps, args.plain)})
    for share in cs.LIVE_SHARES:
        active = torch.as_tensor(cs.live_mask(n, share, seed=n), device=device)
        emit({"mode": "synthetic", "share": share,
              **measure(cs, stream, cols, active, cs.EPS, args.reps, args.plain)})
    del soup, stream, rays, cols
    tables, kept = record_wave(cs, device)
    total = {"us": 0.0, "live": 0, "launches": len(kept)}
    for i, (t_min, _, probe_cols, active) in enumerate(kept):
        line = measure(cs, tables.em_stream, probe_cols, active, t_min, args.reps, args.plain)
        total["us"] += line["us"]
        total["live"] += line["live"]
        if args.plain:
            total["bound_us"] = total.get("bound_us", 0.0) + line["bound_us"]
            total["bit_equal"] = total.get("bit_equal", True) and line["bit_equal"]
        emit({"mode": "soup_wave", "launch": i, **line})
    emit({"mode": "soup_wave_sum", "stream_bytes": tables.em_stream.nbytes, **total})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
