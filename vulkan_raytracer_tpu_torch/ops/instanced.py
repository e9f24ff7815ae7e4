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
The TLAS part, what XLA fuses of each scan step there, is one hand-written
kernel a step between two prototype launches (:func:`.trace.instance_step`:
the last launch merged, the next instance's box test, rays and bounds), and
the winner's (u, v) one more (:func:`.trace.hit_finish`).  The triangles are
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
  ``t_init = -1``; the next step maps slots to prototype-local ids.

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
from typing import NamedTuple

import torch

from . import trace
from .dense import closest_sweep, ray_columns, shadow_sweep
from .math3 import V3
from .traverse import BVHStreams, walk


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


class Instance(NamedTuple):
    """One instance in a scan: its group, its 12 world->object values, its
    global id and its world box (:func:`_instances`)."""

    group: InstanceGroup
    m: object
    iid: object
    bmin: torch.Tensor
    bmax: torch.Tensor


def _instances(g: InstanceGroup):
    """Each instance of the group, in order: its 12 world->object values
    ((12,)), its global id (0-d) and its world box, as views of the group's
    tensors where they lie.  A step reads them there (on a card through
    pointers), so tables whose instances moved replay a captured step
    (``render/graphs.py``); the products with the rays are float32 as they
    would be with the values on the host."""
    return zip(g.inv.unbind(0), g.inst_id.unbind(0), g.aabb_min.unbind(0), g.aabb_max.unbind(0))


def _scan(inst: InstanceTables):
    """Every instance of every group, in prototype order and DFS order within."""
    for g in inst.groups:
        for m, iid, bmin, bmax in _instances(g):
            yield Instance(g, m, iid, bmin, bmax)


def instanced_closest(tables, o: V3, d: V3, *, t_min, t_max, active):
    """Closest hit over every instance; returns (t, enc_tri, u, v).

    ``enc_tri`` is the encoded (instance, prototype-triangle) id, -1 on a
    miss (then t = inf, u = v = 0).  ``t_min``/``t_max`` may be per lane (the
    alpha resample loop).  Each instance is one step (:func:`.trace.instance_step`)
    and one launch; a last step merges the last launch, and the finish
    (:func:`.trace.hit_finish`) recomputes the winner's (u, v)."""
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    rays = ray_columns(o, d)
    scalar = isinstance(t_min, (int, float))  # the first step writes t_lo
    t_lo = None if scalar else trace.lanes(t_min, n, o.x.device).contiguous()
    st = trace.instance_state(n, o.x.device, shadow=False, t_lo=scalar)
    STATS["closest_calls"] += 1
    prev = None
    for x in _scan(inst):
        st = trace.instance_step(tables, st, rays, active, t_max, t_min if scalar else None, prev,
                                 x, shadow=False)
        STATS["steps"] += 1
        lo = st["t_lo"] if scalar else t_lo
        if x.group.pblas is None:
            t_n, hit = closest_sweep(x.group.table, st["rays"], lo, st["t_init"])
        else:
            t_n, hit = walk(x.group.pblas, st["rays"], lo, st["t_init"], shadow=False)
        prev = (x, t_n, hit)
    st = trace.instance_step(tables, st, rays, active, t_max, None, prev, None, shadow=False)
    return trace.hit_finish(tables, rays, st["t_best"], st["enc"], "instanced")


def instanced_shadow(tables, o: V3, d: V3, *, t_max, active):
    """Any-hit occlusion over every instance (tMin = 0); inactive lanes are
    never occluded, and an occluded lane is dead for the later instances.
    Each instance is one step (:func:`.trace.instance_step`) and one launch;
    a last step merges the last launch."""
    inst: InstanceTables = tables.inst
    n = o.x.shape[0]
    rays = ray_columns(o, d)
    walks = any(g.pblas is not None for g in inst.groups)  # the walks read t_lo = 0
    st = trace.instance_state(n, o.x.device, shadow=True, t_lo=walks)
    STATS["shadow_calls"] += 1
    prev = None
    for x in _scan(inst):
        st = trace.instance_step(tables, st, rays, active, t_max, 0.0 if walks else None, prev,
                                 x, shadow=True)
        STATS["steps"] += 1
        if x.group.pblas is None:
            hit = shadow_sweep(x.group.table, st["rays"], st["t_init"])
        else:
            _, hit = walk(x.group.pblas, st["rays"], st["t_lo"], st["t_init"], shadow=True)
        prev = (x, None, hit)
    st = trace.instance_step(tables, st, rays, active, t_max, None, prev, None, shadow=True)
    return st["occ"]
