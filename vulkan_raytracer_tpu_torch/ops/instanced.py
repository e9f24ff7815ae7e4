"""Two-level (TLAS/BLAS) traversal for instanced scenes.

Port of :mod:`vulkan_raytracer_tpu.ops.instanced`.  The reference shares one
BLAS across many TLAS instances with per-instance 3x4 transforms
(accelerationstructure.cpp:157-177); flattening every instance to world space
costs O(instances x triangles) memory.  An instanced upload
(``Scene.upload(instancing=...)``) keeps shared geometry once:

* **prototype columns**: ``SceneTables.v0/...`` hold each unique primitive's
  triangles once, in *object space*;
* **instance tables** (:class:`InstanceTables`): per-instance world->object
  affine transforms, inverse-transpose rotations for normals and world
  AABBs, grouped by prototype (:class:`InstanceGroup`);
* **traversal**: per group, instance by instance in DFS order.  The world
  AABB slab test with the running bound plays the TLAS role; the rays map
  into the instance's object space (the direction by the linear part only,
  so t stays in world units and the running closest-hit bound tightens
  across instances); then the prototype is intersected, with the lanes that
  miss the box marked dead.

The contract is the JAX module's; its ``lax.scan`` schedule is not kept.
The TLAS part is plain torch, as it is plain XLA there.  The triangles are
intersected by the port's hand-written kernels and nothing else on a card:

* a **dense prototype** (at most ``DENSE_MAX_TRIS`` triangles, ``pblas``
  None) takes the dense sweeps ``closest_sweep`` / ``shadow_sweep``
  (``ops/dense.py``) on the group's own contiguous (9, T) table, where the
  JAX module folds in XLA (``_fold_closest`` :140, the shadow fold :292).
  Dead lanes carry ``t_init = 0`` / ``t_hi = 0``;
* a **big prototype** walks the group's own ``BVHStreams`` through
  ``traverse.walk`` (the treelet walk, or the whole-stream walk for a
  single-treelet BLAS) with ``t_lo`` per lane, as ``packet_closest_pb`` /
  ``packet_shadow_pb`` do (pallas_bvh.py:1629, :1693).  Dead lanes carry
  ``t_init = -1``; slots map to prototype-local ids by ``slot_to_tri``.

On CPU tensors the same calls run the kernels' plain versions.

Hit identity is the encoded id ``instance * num_proto_tris + proto_tri`` (the
analogue of ``gl_InstanceCustomIndexEXT`` + ``gl_PrimitiveID``, hit.rchit:33).
An instance replaces the running hit only when strictly closer, so the first
instance in DFS order wins an exact tie.

Left out: the JAX fold's prefilter of constant-alpha MASK triangles
(``_range_columns`` :132-136).  The alpha resample loop of the integrator
rejects such a candidate without drawing a random number and traces on past
it, so the images agree (tests/test_torch_instancing.py holds the
MASK-textured scene against the flattened render).

The JAX module skips an instance whose box no live lane touches with a
device-side ``lax.cond(jnp.any(touches))`` (:229, :314).  Here every
instance step launches, and the test stays on the device as a mask: a lane
that is dead or misses the box carries bound -1 into the walks and 0 into
the dense sweeps, so the kernels skip it (K5' skips a block with no live
lane; K1/K2 compact live lanes per block) and the plain versions return at
once when no lane is live.  No step reads the device on the host, so a
bounce can be captured as a CUDA graph (``render/graphs.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from .dense import _lanes, closest_sweep, ray_columns, shadow_sweep
from .math3 import V3, v3_gather
from .traverse import BVHStreams, safe_inv_dir, slot_to_tri, walk

_F32 = torch.float32

#: Since the last reset: calls of the two entry points and their instance
#: ``steps`` (one launch each).
STATS = {"closest_calls": 0, "shadow_calls": 0, "steps": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class InstanceGroup:
    """All instances of one prototype (a unique primitive)."""

    inv: torch.Tensor  # (Ip, 12) row-major 3x4 world->object transforms
    aabb_min: torch.Tensor  # (Ip, 3) world-space instance bounds
    aabb_max: torch.Tensor  # (Ip, 3)
    inst_id: torch.Tensor  # (Ip,) i32 global instance index
    #: ThreadedBVH over the prototype's object-space triangles when it has
    #: more than ``DENSE_MAX_TRIS`` of them, else None
    blas: object
    #: the BVHStreams of the same BLAS, which the BVH kernels walk
    pblas: BVHStreams | None
    #: contiguous (9, tri_cnt) [v0, e1, e2] table of a dense prototype, which
    #: the dense sweeps read; None with a BLAS
    table: torch.Tensor | None
    tri_off: int
    tri_cnt: int


@dataclasses.dataclass(frozen=True)
class InstanceTables:
    """Scene-level instancing state carried inside ``SceneTables``."""

    groups: tuple  # tuple[InstanceGroup, ...] in prototype order
    inv_flat: torch.Tensor  # (12, I) world->object rows (gatherable columns)
    nrm_flat: torch.Tensor  # (9, I) inverse-transpose rotation rows
    num_instances: int
    num_proto_tris: int

    def decode(self, enc):
        """Encoded hit id -> (prototype triangle, instance)."""
        p = self.num_proto_tris
        return torch.remainder(enc, p), torch.div(enc, p, rounding_mode="floor")

    def to(self, device) -> "InstanceTables":
        from ..scene.scenegraph import _to

        return _to(self, torch.device(device))


def group_table(v0: V3, v1: V3, v2: V3, off: int, cnt: int) -> torch.Tensor:
    """The contiguous (9, cnt) [v0, e1, e2] table of the prototype whose
    triangles are rows ``off : off + cnt`` of the vertex columns."""
    sl = slice(off, off + cnt)
    return torch.stack([
        v0.x[sl], v0.y[sl], v0.z[sl],
        v1.x[sl] - v0.x[sl], v1.y[sl] - v0.y[sl], v1.z[sl] - v0.z[sl],
        v2.x[sl] - v0.x[sl], v2.y[sl] - v0.y[sl], v2.z[sl] - v0.z[sl],
    ]).contiguous()


def apply_normal_matrix(inst: InstanceTables, ii, v: V3) -> V3:
    """Object-space normal/tangent -> world by the instance's
    inverse-transpose rotation (hit.rchit:59-60); 9 flat gathers."""
    m = tuple(torch.index_select(inst.nrm_flat[k], 0, ii) for k in range(9))
    return V3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[3] * v.x + m[4] * v.y + m[5] * v.z,
        m[6] * v.x + m[7] * v.y + m[8] * v.z,
    )


def _apply_affine(m, p: V3) -> V3:
    """3x4 row-major affine transform of points; ``m`` holds 12 numbers or
    12 (N,) tensors."""
    return V3(
        m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
        m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
        m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11],
    )


def _apply_linear(m, v: V3) -> V3:
    """Rotation/scale part only (directions; t stays in world units)."""
    return V3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[4] * v.x + m[5] * v.y + m[6] * v.z,
        m[8] * v.x + m[9] * v.y + m[10] * v.z,
    )


def _instances(g: InstanceGroup):
    """Each instance of the group, in order: its 12 world->object values, its
    global id and its world box, as views of the group's tensors where they
    lie (0-d for the values and the id).  A captured step reads them there,
    so tables whose instances moved replay it (``render/graphs.py``); the
    products with the rays are float32 as they would be with the values on
    the host."""
    return zip((row.unbind(0) for row in g.inv.unbind(0)), g.inst_id.unbind(0),
               g.aabb_min.unbind(0), g.aabb_max.unbind(0))


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test of (N, 3) rays against one box: does [t_min, t_max] meet
    the box interval?  (``ray_aabb``, vulkan_raytracer_tpu/ops/intersect.py:31)"""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max)


def instanced_closest(tables, o: V3, d: V3, *, t_min, t_max, active):
    """Closest hit over every instance; returns (t, enc_tri, u, v).

    ``enc_tri`` is the encoded (instance, prototype-triangle) id, -1 on a
    miss (then t = inf, u = v = 0).  ``t_min``/``t_max`` may be per lane (the
    alpha resample loop)."""
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    dev = o.x.device
    p_total = inst.num_proto_tris
    t_lo = _lanes(t_min, n, dev).contiguous()
    o_arr = o.to_array()
    inv_d = safe_inv_dir(d.to_array())
    STATS["closest_calls"] += 1

    # inactive lanes carry t_best = 0: no triangle can pass their interval
    t_best = torch.where(active, _lanes(t_max, n, dev), 0.0)
    enc = torch.full((n,), -1, dtype=torch.int32, device=dev)

    for g in inst.groups:
        for m, iid, bmin, bmax in _instances(g):
            # a dead lane's bound 0 would pass the box where its origin lies inside
            touches = active & ray_aabb(o_arr, inv_d, bmin, bmax, 0.0, t_best)
            STATS["steps"] += 1
            rays = ray_columns(_apply_affine(m, o), _apply_linear(m, d))
            if g.pblas is None:
                t_n, local = closest_sweep(g.table, rays, t_lo,
                                           torch.where(touches, t_best, 0.0))
            else:
                t_n, slot = walk(g.pblas, rays, t_lo, torch.where(touches, t_best, -1.0),
                                 shadow=False)
                local, _ = slot_to_tri(g.pblas, slot)
            # strictly closer: the first instance in DFS order keeps an exact tie
            closer = (local >= 0) & (t_n < t_best)
            t_best = torch.where(closer, t_n, t_best)
            enc = torch.where(closer, local + (iid * p_total + g.tri_off), enc)

    found = enc >= 0
    # (u, v) once, for the winning (instance, triangle), in its object space
    pti, ii = inst.decode(torch.clamp_min(enc, 0))
    ii = torch.clamp_max(ii, inst.num_instances - 1)
    m = tuple(torch.index_select(inst.inv_flat[k], 0, ii) for k in range(12))
    o2 = _apply_affine(m, o)
    d2 = _apply_linear(m, d)
    wv0 = v3_gather(tables.v0, pti)
    e1 = v3_gather(tables.v1, pti) - wv0
    e2 = v3_gather(tables.v2, pti) - wv0
    pvec = d2.cross(e2)
    det = e1.dot(pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    tvec = o2 - wv0
    u = tvec.dot(pvec) * inv_det
    v = d2.dot(tvec.cross(e1)) * inv_det
    return (
        torch.where(found, t_best, torch.inf),
        torch.where(found, enc, -1),
        torch.where(found, u, 0.0),
        torch.where(found, v, 0.0),
    )


def instanced_shadow(tables, o: V3, d: V3, *, t_max, active):
    """Any-hit occlusion over every instance (tMin = 0); inactive lanes are
    never occluded, and an occluded lane is dead for the later instances."""
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    dev = o.x.device
    t_bound = _lanes(t_max, n, dev)
    o_arr = o.to_array()
    inv_d = safe_inv_dir(d.to_array())
    zeros = torch.zeros(n, dtype=_F32, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    STATS["shadow_calls"] += 1

    for g in inst.groups:
        for m, _, bmin, bmax in _instances(g):
            touches = (active & ~occ) & ray_aabb(o_arr, inv_d, bmin, bmax, 0.0, t_bound)
            STATS["steps"] += 1
            rays = ray_columns(_apply_affine(m, o), _apply_linear(m, d))
            if g.pblas is None:
                hit = shadow_sweep(g.table, rays, torch.where(touches, t_bound, 0.0)) != 0
            else:
                _, slot = walk(g.pblas, rays, zeros, torch.where(touches, t_bound, -1.0),
                               shadow=True)
                hit = slot >= 0
            occ = occ | (hit & touches)
    return occ & active
