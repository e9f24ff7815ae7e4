"""Dense ray/triangle sweeps: every ray against every triangle.

The port's counterpart of ``vulkan_raytracer_tpu/ops/pallas_dense.py`` (the
three Pallas kernels, reached through ``pallas_closest`` :262,
``pallas_shadow`` :301 and ``pallas_emissive_pdf`` :371) and of the XLA fold
in ``vulkan_raytracer_tpu/ops/dense.py`` (``dense_closest`` :132,
``dense_shadow`` :190, ``dense_emissive_pdf`` :207).  Each sweep has

* a CUDA kernel, hand-written for Hopper (``csrc/dense_sweep.cu``), which
  the sweep launches for CUDA tensors — after checking device, dtype, shape
  and contiguity — and counts in :data:`LAUNCHES`; there is no fallback;
* a plain PyTorch version (``*_sweep_reference``): triangle-chunked
  ``(CHUNK, N)`` broadcasts with the kernel's exact contract and operation
  order, which the sweep runs for CPU tensors and which the tests and
  ``chip_smoke.py`` hold the kernel against.

The public functions take the JAX wrappers' signatures and return the same
values: ``dense_closest`` -> (t, tri, u, v) with t = inf / tri = -1 on a miss,
``dense_shadow`` -> occluded flags, ``dense_emissive_pdf`` -> the summed pdf.
The kernel contract follows the Pallas kernels (a hit at exactly the initial
t bound counts), which every scene of the port's dense path uses.

Dead lanes.  The kernels gather each block's live lanes before they test
(``t_init > t_lo``; ``t_hi > 0``; ``gate != 0``).  A dead closest lane
returns t_init and -1 and a dead occlusion lane 0, as the plain versions do.
A pdf lane whose gate is 0 returns +0; the plain version (and the JAX
kernel) return pdf * 0, which is +0 whenever the sum is finite.  The
integrator never reads such a lane.
"""

from __future__ import annotations

import torch

from . import _ext, trace
from .math3 import V3

#: Scenes above this many triangles are uploaded with BVH streams and walk
#: them (ops/traverse.py); this kernel itself has no triangle cap.
DENSE_MAX_TRIS = 65536
#: Emissive sets above this size take the emissive-BVH probe
#: (ops/traverse.py ``bvh_emissive_pdf``) instead of the dense pdf sweep.
EMISSIVE_MAX_TRIS = 1024

#: Triangles per step of the plain versions' (CHUNK, N) broadcast.
CHUNK = 64

#: Kernel launches since the last reset, by kernel.  Only a launch adds one.
LAUNCHES = {"closest": 0, "shadow": 0, "pdf": 0}

_F32 = torch.float32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Tables and rays in the kernels' layout
# ---------------------------------------------------------------------------


def closest_table(tables) -> torch.Tensor:
    """(9, T) float32 [v0.xyz, e1.xyz, e2.xyz] (pallas_dense.py:238-247);
    the sweeps read it once per scene as ``SceneTables.tri_table``."""
    v0, v1, v2 = tables.v0, tables.v1, tables.v2
    return torch.stack([
        v0.x, v0.y, v0.z,
        v1.x - v0.x, v1.y - v0.y, v1.z - v0.z,
        v2.x - v0.x, v2.y - v0.y, v2.z - v0.z,
    ]).contiguous()


def pdf_table(tables) -> torch.Tensor:
    """(20, Te) float32 [v0, e1, e2, p_delta, max(area, 1e-30), n0, n1, n2]
    (pallas_dense.py:375-385); read once per scene as
    ``SceneTables.em_table``."""
    em = tables.em_tables
    ev0, ev1, ev2 = tables.em_v0, tables.em_v1, tables.em_v2
    return torch.stack([
        ev0.x, ev0.y, ev0.z,
        ev1.x - ev0.x, ev1.y - ev0.y, ev1.z - ev0.z,
        ev2.x - ev0.x, ev2.y - ev0.y, ev2.z - ev0.z,
        em.p_delta, torch.clamp_min(em.area, 1e-30),
        em.n0[:, 0], em.n0[:, 1], em.n0[:, 2],
        em.n1[:, 0], em.n1[:, 1], em.n1[:, 2],
        em.n2[:, 0], em.n2[:, 1], em.n2[:, 2],
    ]).contiguous()


def ray_columns(o: V3, d: V3):
    """The six ray components as contiguous float32 (N,) tensors."""
    return tuple(c.to(_F32).contiguous() for c in (o.x, o.y, o.z, d.x, d.y, d.z))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------


def mt(tri, ray):
    """Möller-Trumbore in the kernels' operation order (csrc ``mt_inside``,
    pallas_dense.py:55-85), broadcasting ``tri`` (9 tensors: v0.xyz,
    e1.xyz, e2.xyz) against ``ray`` (6 tensors: o.xyz, d.xyz).  Returns
    (inside, u, v, t)."""
    ox, oy, oz, dx, dy, dz = ray
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    near0 = torch.abs(det) < 1e-12
    inv = torch.reciprocal(torch.where(near0, 1.0, det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    inside = ~near0 & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return inside, u, v, t


def _mt_chunk(rows, rays):
    """Möller-Trumbore on (C, 1) triangle rows x (1, N) rays."""
    return mt(rows[:9], [r[None, :] for r in rays])


def _chunks(table):
    n_tris = table.shape[1]
    for s in range(0, n_tris, CHUNK):
        yield s, table[:, s:s + CHUNK, None]


def closest_sweep_reference(table, rays, t_lo, t_init):
    """Plain version of the closest-hit kernel.  Returns (t_best, tri_best):
    t_best = t_init and tri_best = -1 where nothing hit.  With no live lane
    (t_init > t_lo) nothing can hit, and it returns at once."""
    n = rays[0].shape[0]
    t_best = t_init.clone()
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=t_init.device)
    if not bool((t_init > t_lo).any()):
        return t_best, tri_best
    for s, rows in _chunks(table):
        inside, _, _, t = _mt_chunk(rows, rays)
        hit = inside & (t > t_lo[None, :]) & (t <= t_best[None, :])
        t_chunk = torch.where(hit, t, torch.inf).amin(dim=0)
        ids = torch.arange(s, s + rows.shape[1], dtype=torch.int32, device=t.device)
        first = torch.where(hit & (t == t_chunk[None, :]), ids[:, None], 2**30).amin(dim=0)
        # the lowest id at the chunk's least t; across chunks an equal t keeps
        # the earlier (lower) id, exactly as the kernel's replace rule
        replace = hit.any(dim=0) & ((t_chunk < t_best) | (tri_best < 0))
        t_best = torch.where(replace, t_chunk, t_best)
        tri_best = torch.where(replace, first, tri_best)
    return t_best, tri_best


def shadow_sweep_reference(table, rays, t_hi):
    """Plain version of the occlusion kernel: int32 1 where some triangle
    hits with 0 < t <= t_hi (none, at once, without a lane whose t_hi > 0)."""
    occ = torch.zeros(rays[0].shape[0], dtype=torch.bool, device=t_hi.device)
    if not bool((t_hi > 0.0).any()):
        return occ.to(torch.int32)
    for _, rows in _chunks(table):
        inside, _, _, t = _mt_chunk(rows, rays)
        occ = occ | (inside & (t > 0.0) & (t <= t_hi[None, :])).any(dim=0)
    return occ.to(torch.int32)


def pdf_sweep_reference(table, rays, gate, t_min: float):
    """Plain version of the emissive-pdf kernel (sums per chunk, so the order
    of the additions differs from the kernel's)."""
    dx, dy, dz = (r[None, :] for r in rays[3:])
    pdf = torch.zeros(rays[0].shape[0], dtype=_F32, device=gate.device)
    for _, rows in _chunks(table):
        inside, u, v, t = _mt_chunk(rows, rays)
        hit = inside & (t > t_min)
        w0 = 1.0 - u - v
        nx = w0 * rows[11] + u * rows[14] + v * rows[17]
        ny = w0 * rows[12] + u * rows[15] + v * rows[18]
        nz = w0 * rows[13] + u * rows[16] + v * rows[19]
        inv_len = torch.rsqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30))
        cosine = torch.abs(nx * dx + ny * dy + nz * dz) * inv_len
        contrib = rows[9] * t * t / torch.clamp_min(rows[10] * cosine, 1e-30)
        pdf = pdf + torch.where(hit, contrib, 0.0).sum(dim=0)
    return pdf * gate


# ---------------------------------------------------------------------------
# Sweeps: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def _on_cuda(tensors) -> bool:
    """True if every tensor is on one CUDA device, False if all are on the
    CPU; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"dense sweep inputs span devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"dense sweeps run on cpu or cuda tensors, not {dev}")


def _check_launch(table, rows: int, columns, n: int):
    if table.dtype != _F32 or table.dim() != 2 or table.shape[0] != rows:
        raise ValueError(f"triangle table must be ({rows}, T) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("triangle table must be contiguous")
    for c in columns:
        if c.dtype != _F32 or tuple(c.shape) != (n,) or not c.is_contiguous():
            raise ValueError(f"ray columns must be contiguous ({n},) float32, got "
                             f"{tuple(c.shape)} {c.dtype}")
    if table.shape[1] >= 2**31 or n >= 2**31:
        raise ValueError("dense sweeps take fewer than 2**31 rays and triangles")


def _launch(name, fn, table, args, n):
    """Launch one kernel over the table and count it; ``args`` follow the
    table in the C signature."""
    _ext.launch(fn, table.device, table, table.shape[1], *args, n)
    LAUNCHES[name] += 1


def closest_sweep(table, rays, t_lo, t_init):
    """Closest hit per ray over the (9, T) table; see closest_sweep_reference."""
    if not _on_cuda((table, *rays, t_lo, t_init)):
        return closest_sweep_reference(table, rays, t_lo, t_init)
    n = rays[0].shape[0]
    _check_launch(table, 9, (*rays, t_lo, t_init), n)
    t_out = torch.empty(n, dtype=_F32, device=table.device)
    tri_out = torch.empty(n, dtype=torch.int32, device=table.device)
    _launch("closest", "dense_closest_launch", table, (*rays, t_lo, t_init, t_out, tri_out), n)
    return t_out, tri_out


def shadow_sweep(table, rays, t_hi):
    """Occlusion flag (int32) per ray over the (9, T) table."""
    if not _on_cuda((table, *rays, t_hi)):
        return shadow_sweep_reference(table, rays, t_hi)
    n = rays[0].shape[0]
    _check_launch(table, 9, (*rays, t_hi), n)
    occ = torch.empty(n, dtype=torch.int32, device=table.device)
    _launch("shadow", "dense_shadow_launch", table, (*rays, t_hi, occ), n)
    return occ


def pdf_sweep(table, rays, gate, t_min: float):
    """Gated emissive pdf per ray over the (20, Te) table; the kernel gives +0
    where the gate is 0 (see the module's note on dead lanes)."""
    if not _on_cuda((table, *rays, gate)):
        return pdf_sweep_reference(table, rays, gate, t_min)
    n = rays[0].shape[0]
    _check_launch(table, 20, (*rays, gate), n)
    out = torch.empty(n, dtype=_F32, device=table.device)
    _launch("pdf", "dense_pdf_launch", table, (*rays, gate, float(t_min), out), n)
    return out


# ---------------------------------------------------------------------------
# Public entry points (the JAX wrappers' signatures)
# ---------------------------------------------------------------------------


def dense_closest(tables, o: V3, d: V3, *, t_min, t_max, active, raw: bool = False):
    """Closest hit over all triangles: (t, tri, u, v), t = inf / tri = -1 on
    a miss (pallas_dense.py:262-298).  With ``raw``, the sweep's result
    unfinished, (rays, t, tri, "dense"): an alpha pass's commit finishes it
    (:func:`.trace.hit_finish`'s arguments)."""
    n = o.x.shape[0]
    dev = o.x.device
    t_lo = trace.lanes(t_min, n, dev).contiguous()
    t_init = torch.where(active, trace.lanes(t_max, n, dev), 0.0).contiguous()
    rays = ray_columns(o, d)
    t_best, tri_best = closest_sweep(tables.tri_table, rays, t_lo, t_init)
    if raw:
        return rays, t_best, tri_best, "dense"
    return trace.hit_finish(tables, rays, t_best, tri_best, "dense")


def dense_shadow(tables, o: V3, d: V3, *, t_max, active):
    """Any-hit occlusion over all triangles (tMin = 0, lightsample.glsl:27);
    inactive lanes are never occluded (pallas_dense.py:301-309)."""
    n = o.x.shape[0]
    t_hi = torch.where(active, trace.lanes(t_max, n, o.x.device), 0.0).contiguous()
    occ = shadow_sweep(tables.tri_table, ray_columns(o, d), t_hi)
    return (occ != 0) & active


def dense_emissive_pdf(tables, o: V3, d: V3, *, t_min, active):
    """Sum of the NEE pdf over every emissive triangle along each ray
    (shaders/emissivepdf.rahit:57-67; pallas_dense.py:371-390)."""
    gate = torch.where(active, 1.0, 0.0).to(_F32).contiguous()
    return pdf_sweep(tables.em_table, ray_columns(o, d), gate, float(t_min))
