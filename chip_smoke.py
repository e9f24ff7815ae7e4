#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and ends the run with a
nonzero exit code:

1. device  — CUDA must be available (no CPU fallback); the card's name and
   power limit from nvidia-smi.
2. build   — compile the CUDA kernels from ``vulkan_raytracer_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card,
   over the Cornell box and over a 1,000-triangle soup (several
   shared-memory chunks), at bench cfg1's wave of 524,288 rays and at a
   ragged 524,251 (a block partly past the last ray), with inactive lanes,
   t bounds before, across, at and beyond the hits, and the pdf at both
   t_min the render uses; then times at the cfg1 wave.
4. render  — the CLI's headless path for bench cfg1 (Cornell, 512x512,
   depth 4, 64 spp, camera 0,1,2.4 -> 0,0,-1) on ``cuda``; every kernel must
   have been launched by it, and the image must be finite and lit.
5. cpu     — Cornell 32x32, 2 spp, depth 3 through the port on ``cuda``
   against the same render on the CPU, where the port runs the plain
   versions that tests/test_torch_render.py holds against the JAX renderer
   and its NumPy oracle; per-pixel RMSE < 2e-3, ray counts within 0.1%.

Then it prints the kernel summary (one JSON object), the nvidia-smi line,
and, last, ``{"ok": true, "device": {...}}``.  Neither the script nor the
port imports jax or the JAX package; phase 5 checks that.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RMSE_BAR = 2e-3
EPS = 1e-7
INF = 1e32
KERNELS = {  # name -> (launch counter, TPU kernel it replaces)
    "dense_closest": ("closest", "vulkan_raytracer_tpu/ops/pallas_dense.py:112"),
    "dense_shadow": ("shadow", "vulkan_raytracer_tpu/ops/pallas_dense.py:144"),
    "dense_emissive_pdf": ("pdf", "vulkan_raytracer_tpu/ops/pallas_dense.py:318"),
}
SOURCE = "vulkan_raytracer_tpu_torch/csrc/dense_sweep.cu"
CFG1 = ["-m", "cornell", "-r", "512,512", "-b", "4", "--spp", "64",
        "-c", "0,1,2.4", "-d", "0,0,-1"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def soup_scene(n_tris: int, seed: int):
    """A random triangle soup in the Cornell volume, every triangle emissive
    (so the pdf table has n_tris rows too)."""
    from vulkan_raytracer_tpu_torch.scene.scenegraph import Material, Scene

    r = np.random.default_rng(seed)
    base = r.uniform([-1.0, 0.0, -1.0], [1.0, 2.0, 1.0], (n_tris, 3)).astype(np.float32)
    offs = r.normal(0.0, 0.15, (n_tris, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + offs[:, 0], base + offs[:, 1]], axis=1).reshape(-1, 3)
    nrm = np.cross(offs[:, 0], offs[:, 1])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
    m = Material()
    m.emissive_factor = np.full(3, 2.0, np.float32)
    s = Scene()
    s.add_raw_mesh(pos, np.repeat(nrm, 3, axis=0).astype(np.float32),
                   np.arange(3 * n_tris, dtype=np.uint32), m)
    return s


def make_rays(n: int, seed: int, device):
    """Random rays inside the Cornell box, with inactive lanes and a mix of
    per-lane t bounds."""
    import torch

    from vulkan_raytracer_tpu_torch.ops.math3 import V3

    r = np.random.default_rng(seed)
    o = r.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kind = r.integers(0, 4, n)
    t_max = np.where(kind == 0, INF, np.where(kind == 1, r.uniform(0.0, 0.3, n),
                                              r.uniform(0.3, 4.0, n))).astype(np.float32)
    t_min = np.where(kind == 3, r.uniform(0.0, 0.5, n), EPS).astype(np.float32)
    active = r.random(n) < 0.8

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(
        o=V3(col(o[:, 0]), col(o[:, 1]), col(o[:, 2])),
        d=V3(col(d[:, 0]), col(d[:, 1]), col(d[:, 2])),
        t_min=col(t_min), t_max=col(t_max), active=col(active),
    )


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_kernels(tables_by_name, ray_counts, device) -> dict:
    """Kernel vs plain version on the card, for every table and ray count;
    returns the largest absolute error measured per kernel.  Tri ids,
    occlusion flags and t/u/v must be bit-equal; the pdf, at both t_min the
    render uses (EPS and 0.0), within rtol 1e-5 / atol 1e-7."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    err = {k: 0.0 for k in KERNELS}
    seed = 0
    for name, tables in tables_by_name.items():
        table, ptable = tables.tri_table, tables.em_table
        for n_rays in ray_counts:
            seed += 1
            rays = make_rays(n_rays, seed=seed, device=device)
            cols = dense.ray_columns(rays["o"], rays["d"])
            active = rays["active"]
            t_lo = rays["t_min"].contiguous()
            t_init = torch.where(active, rays["t_max"], 0.0).contiguous()
            where = f"{name}, {n_rays} rays"

            # closest hit: ids, t and the recomputed (u, v)
            t_k, tri_k = dense.closest_sweep(table, cols, t_lo, t_init)
            t_p, tri_p = dense.closest_sweep_reference(table, cols, t_lo, t_init)
            # lanes bounded at exactly their hit t must still hit (the replace rule)
            t_tie = torch.where(tri_p >= 0, t_p, t_init).contiguous()
            t_k2, tri_k2 = dense.closest_sweep(table, cols, t_lo, t_tie)
            t_p2, tri_p2 = dense.closest_sweep_reference(table, cols, t_lo, t_tie)
            uk, vk = dense.winner_uv(tables, rays["o"], rays["d"], tri_k)
            up, vp = dense.winner_uv(tables, rays["o"], rays["d"], tri_p)
            closest_err = max(_max_abs(t_k, t_p), _max_abs(t_k2, t_p2),
                              _max_abs(uk, up), _max_abs(vk, vp))
            bad_ids = int((tri_k != tri_p).sum()) + int((tri_k2 != tri_p2).sum())
            err["dense_closest"] = max(err["dense_closest"], closest_err)
            if bad_ids or closest_err != 0.0:
                raise AssertionError(f"{where}: closest differs on {bad_ids} ids, "
                                     f"max abs t/u/v error {closest_err}")
            if not torch.equal(tri_k2, tri_p):
                raise AssertionError(f"{where}: a hit at exactly t_init was dropped")

            # occlusion: flags bit-equal
            t_hi = torch.where(active, rays["t_max"], 0.0).contiguous()
            occ_k = dense.shadow_sweep(table, cols, t_hi)
            occ_p = dense.shadow_sweep_reference(table, cols, t_hi)
            shadow_err = _max_abs(occ_k, occ_p)
            err["dense_shadow"] = max(err["dense_shadow"], shadow_err)
            if shadow_err != 0.0:
                bad = int((occ_k != occ_p).sum())
                raise AssertionError(f"{where}: occlusion differs on {bad} lanes")
            if bool(occ_k[~active].any()):
                raise AssertionError(f"{where}: an inactive lane is occluded")

            # emissive pdf: rtol 1e-5, atol 1e-7 (rsqrtf vs torch.rsqrt, sum order)
            gate = torch.where(active, 1.0, 0.0).contiguous()
            pdf_err = {}
            for t_min in (EPS, 0.0):
                pdf_k = dense.pdf_sweep(ptable, cols, gate, t_min)
                pdf_p = dense.pdf_sweep_reference(ptable, cols, gate, t_min)
                pdf_err[t_min] = _max_abs(pdf_k, pdf_p)
                err["dense_emissive_pdf"] = max(err["dense_emissive_pdf"], pdf_err[t_min])
                torch.testing.assert_close(pdf_k, pdf_p, rtol=1e-5, atol=1e-7)
            emit({"phase": "kernels", "table": name, "triangles": table.shape[1],
                  "emissive": ptable.shape[1], "rays": n_rays,
                  "hits": int((tri_k >= 0).sum()), "occluded": int(occ_k.sum()),
                  "pdf_lanes": int((pdf_k > 0).sum()), "closest_max_abs_err": closest_err,
                  "shadow_max_abs_err": shadow_err, "pdf_max_abs_err_t_min_eps": pdf_err[EPS],
                  "pdf_max_abs_err_t_min_0": pdf_err[0.0]})
    return err


def time_kernels(tables, n: int, device) -> dict:
    """Each kernel and its plain version at bench cfg1's launch shape (n rays
    over the Cornell tables), in turns plain, kernel, kernel, plain."""
    import torch

    from vulkan_raytracer_tpu_torch.ops import dense

    rays = make_rays(n, seed=99, device=device)
    cols = dense.ray_columns(rays["o"], rays["d"])
    table, ptable = tables.tri_table, tables.em_table
    t_lo = torch.full((n,), EPS, dtype=torch.float32, device=device)
    t_init = torch.where(rays["active"], INF, 0.0).to(torch.float32).contiguous()
    t_hi = torch.where(rays["active"], rays["t_max"], 0.0).contiguous()
    gate = torch.where(rays["active"], 1.0, 0.0).to(torch.float32).contiguous()
    pairs = {
        "dense_closest": (lambda: dense.closest_sweep(table, cols, t_lo, t_init),
                          lambda: dense.closest_sweep_reference(table, cols, t_lo, t_init)),
        "dense_shadow": (lambda: dense.shadow_sweep(table, cols, t_hi),
                         lambda: dense.shadow_sweep_reference(table, cols, t_hi)),
        "dense_emissive_pdf": (lambda: dense.pdf_sweep(ptable, cols, gate, EPS),
                               lambda: dense.pdf_sweep_reference(ptable, cols, gate, EPS)),
    }
    out = {}
    for name, (kernel, plain) in pairs.items():
        p1, k1, k2, p2 = (time_ms(plain, 10), time_ms(kernel, 50),
                          time_ms(kernel, 50), time_ms(plain, 10))
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
    emit({"phase": "kernel_times", "rays": n, "triangles": table.shape[1], **out})
    return out


def main() -> int:
    if not (ROOT / "vulkan_raytracer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the vulkan_raytracer_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke test needs an NVIDIA card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    from vulkan_raytracer_tpu_torch.ops import _ext, dense

    t0 = time.perf_counter()
    lib_path = _ext.build()
    _ext.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name})

    # 3. kernels
    from vulkan_raytracer_tpu_torch.scene.builtin import cornell_box_scene

    cornell = cornell_box_scene().upload(device)
    soup = soup_scene(1000, seed=7).upload(device)
    n_cfg1 = 2 * 512 * 512  # lanes of one cfg1 wave
    # the cfg1 wave, and a ragged count whose last block is partly past the rays
    errs = check_kernels({"cornell": cornell, "soup1000": soup}, (n_cfg1, n_cfg1 - 37), device)
    times = time_kernels(cornell, n_cfg1, device)

    # 4. render: the CLI's headless path for bench cfg1
    from vulkan_raytracer_tpu_torch import cli

    with tempfile.TemporaryDirectory() as out_dir:
        dense.reset_launches()
        stats = cli.run(CFG1 + ["--device", "cuda", "--output", f"{out_dir}/cfg1.png"])
        launches = dict(dense.LAUNCHES)
    img = stats["image"]
    if not all(launches[c] > 0 for c, _ in KERNELS.values()):
        raise AssertionError(f"cfg1 render missed a kernel: launches {launches}")
    if not np.isfinite(img).all() or img.shape != (512, 512, 3):
        raise AssertionError(f"cfg1 image not finite or misshapen: {img.shape}")
    if not img.mean() > 1e-3:
        raise AssertionError(f"cfg1 image is black (mean {img.mean()})")
    emit({"phase": "render", "config": "cfg1 cornell 512x512 depth 4 64 spp",
          "seconds": stats["seconds"], "rays": stats["rays"],
          "mrays_per_s": stats["mrays_per_s"], "launches": launches,
          "image_mean": float(img.mean())})

    # 5. cpu: the same render through the plain versions on the CPU, which
    # the CPU tests hold against the JAX renderer and its NumPy oracle
    from vulkan_raytracer_tpu_torch.render.renderer import render_image
    from vulkan_raytracer_tpu_torch.scene.camera import Camera

    def cam():
        return Camera(position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0]))

    img_gpu, rays_gpu = render_image(cornell, cam(), 32, 32, spp=2, max_depth=3, tonemap=False)
    img_cpu, rays_cpu = render_image(cornell.to("cpu"), cam(), 32, 32, spp=2, max_depth=3,
                                     tonemap=False)
    rmse = float(np.sqrt(np.mean((img_gpu - img_cpu) ** 2)))
    emit({"phase": "cpu", "config": "cornell 32x32 2 spp depth 3", "rmse": rmse,
          "bar": RMSE_BAR, "rays_cuda": rays_gpu, "rays_cpu": rays_cpu})
    if not (np.isfinite(img_gpu).all() and img_gpu.shape == (32, 32, 3)):
        raise AssertionError("the 32x32 render on the card is not finite or misshapen")
    if not rmse < RMSE_BAR:
        raise AssertionError(f"port on cuda vs port on cpu RMSE {rmse} >= {RMSE_BAR}")
    if abs(rays_gpu - rays_cpu) > 1e-3 * rays_cpu:
        raise AssertionError(f"ray counts differ: {rays_gpu} on cuda, {rays_cpu} on cpu")
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "vulkan_raytracer_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported}")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
         "launches": launches[counter], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
        for name, (counter, replaces) in KERNELS.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
