"""What surrounds the traversal launches: four hand-written CUDA kernels.

The JAX package runs each traversal's finish, its instance scans and its
coherence re-sort under ``jax.jit``, and XLA fuses the code around each
Pallas call: the closest hit's (u, v) (``pallas_closest``
ops/pallas_dense.py:262-298, ``packet_closest`` ops/pallas_bvh.py:1604 with
``_slot_to_tri`` :1343), each ``lax.scan`` step of ``instanced_closest`` and
``instanced_shadow`` (ops/instanced.py:185-234, :279-317) and the finish
after them (:236-262), and the re-sort (``_coherence_key``, ``_sort_wavefront``
render/integrator.py:316-373; the NEE rays' in ``_shadow`` :234-267).  None is
a Pallas kernel.  Here each is one kernel, hand-written for Hopper
(``csrc/trace.cu``), one thread a lane:

* :func:`hit_finish` (``hit_finish_kernel``): the closest hit after its
  traversal, a BVH walk's slot -> the scene triangle, the winner's (u, v)
  (an instanced winner's in its object space), t = inf, tri = -1 and
  u = v = 0 on a miss; one an opaque closest-hit call (an alpha pass's
  commit finishes its pending lanes by the same device function,
  ``csrc/hit_finish.cuh``: ``ops/wave.py``);
* :func:`instance_step` (``instance_step_kernel``): one step of an instance
  scan between two prototype launches: the last launch's result merged into
  the running closest hit (or occlusion), then the next instance's box test,
  its object-space rays and its launch's initial bound, written as the
  columns that launch reads; the call's first step computes 1/d and the
  running state, its last (no next instance) only merges;
* :func:`coherence_key` (``coherence_key_kernel``): the re-sort key over the
  scene's box, read where the tables keep it (:func:`key_box`: the BVH
  root's, or the instanced tables' union box, made at upload and refit), so
  a key is one launch on every scene;
* :func:`permute` (``permute_kernel``): every column of a state gathered,
  scattered or copied by one permutation in one launch: a gather or a
  scatter a thread a lane, every column; a copy column after column on a
  persistent grid (:data:`PERMUTE_BLOCKS_PER_SM` blocks an SM),
  :data:`COPY_CHUNK` bytes an item, 16 a thread.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`, and runs its plain version (``*_reference``) for CPU
tensors; on the card nothing falls back.  The plain versions are the port's
torch code regrouped, not rewritten: :func:`winner_uv` (formerly in
``dense``), :func:`slot_to_tri` (``traverse``), :func:`ray_aabb`,
:func:`_apply_affine` and :func:`_apply_linear` (``instanced``) and the Morton
table (``render/integrator.py``) moved here as they were, and the instance
loops' bodies, their finish and ``_coherence_key`` became the plain
versions, so the CPU render is bit-equal to the one before them.  Tests and
tools reach a plain version on the card by patching this module's wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _ext
from .math3 import V3, safe_inv_dir, v3_gather

_F32 = torch.float32

#: Kernel launches since the last reset, by kernel; ``permute_kernel``'s
#: copies apart (``permute_copy``: a captured program's state copies, which
#: the eager loop does not make).  Only a launch adds one.
LAUNCHES = {"hit_finish": 0, "instance_step": 0, "coherence_key": 0, "permute": 0,
            "permute_copy": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: Columns one :func:`permute` launch moves at most (``kCols`` in the source).
MAX_COLS = 24
#: ``permute_kernel``'s layout (``kCopyChunk``, ``kPermBlocksPerSm`` in the
#: source): the bytes of a copy's item (one column, 16 a thread), and the
#: persistent grid's blocks an SM.
COPY_CHUNK = 256 * 16
PERMUTE_BLOCKS_PER_SM = 8
_RAYS = ("W_OX", "W_OY", "W_OZ", "W_DX", "W_DY", "W_DZ")
_NEXT = ("N_OX", "N_OY", "N_OZ", "N_DX", "N_DY", "N_DZ")
#: One pointer per column, in the order of ``enum Slot`` in csrc/trace.cu.
SLOTS = (
    *_RAYS, "H_T", "H_HIT", "O_T", "O_TRI", "O_U", "O_V",
    "X_ACTIVE", "X_TMAX", "S_INV", "S_TBEST", "S_ENC", "S_OCC", "S_TOUCH", *_NEXT, "N_TLO",
    "N_TINIT", "X_M", "X_BMIN", "X_BMAX", "X_IID", "X_IF", "K_LO", "K_HI", "K_ACTIVE", "K_KEY",
    "T_V0X", "T_V0Y", "T_V0Z", "T_V1X", "T_V1Y", "T_V1Z", "T_V2X", "T_V2Y", "T_V2Z", "T_TRIID",
    "T_INVFLAT", "P_PERM", *(f"P_SRC{k}" for k in range(MAX_COLS)),
    *(f"P_DST{k}" for k in range(MAX_COLS)),
)
#: The counts and flags, in the order of ``enum Int`` in csrc/trace.cu.
INTS = ("I_N", "I_MODE", "I_PROTO_TRIS", "I_NUM_INST", "I_FIRST", "I_PREV", "I_NEXT",
        "I_SHADOW", "I_PREV_BLAS", "I_NEXT_BLAS", "I_TRI_OFF", "I_COLS",
        *(f"I_WIDTH{k}" for k in range(MAX_COLS)))
#: The floats, in the order of ``enum Real`` in csrc/trace.cu.
REALS = ("F_TMIN", "F_TMAX")
#: :func:`hit_finish`'s modes (``enum Finish``): what its ``hit`` holds.
FINISH_MODES = ("dense", "bvh", "instanced")
#: :func:`permute`'s modes (``enum Permute``).
PERMUTE_MODES = ("gather", "scatter", "copy")
_SLOT = {name: k for k, name in enumerate(SLOTS)}
_INT = {name: k for k, name in enumerate(INTS)}
_REAL = {name: k for k, name in enumerate(REALS)}

#: The lane columns each kernel moves (reads or writes; the scene tables,
#: the instance's values and the key's bounds aside) -> the passes over the
#: lanes it moves them in, by the name of a count of :func:`lane_bytes`
#: (None: once over every lane).  tests/test_torch_trace.py holds the
#: columns against the kernels' source.
MOVES = {
    "hit_finish": {**dict.fromkeys(("H_HIT", "O_T", "O_TRI", "O_U", "O_V")),
                   **dict.fromkeys(("H_T", *_RAYS), "found")},
    "instance_step": {"X_ACTIVE": None, "S_INV": None, "X_TMAX": "t_max_lanes",
                      **dict.fromkeys(_RAYS[:3], "next"),
                      **dict.fromkeys(_RAYS[3:], "first_or_next"),
                      "S_TBEST": "closest_state", "S_ENC": "closest_state",
                      "S_OCC": "shadow_state", "S_TOUCH": "touches", "H_HIT": "touched",
                      "H_T": "touched_closest", **dict.fromkeys((*_NEXT, "N_TINIT"), "next"),
                      "N_TLO": "t_lo"},
    "coherence_key": dict.fromkeys((*_RAYS, "K_ACTIVE", "K_KEY")),
    "permute": {"P_PERM": "perm", "P_SRC0": "cols", "P_DST0": "cols"},
}
#: Bytes an element of a lane column (P_SRC0 / P_DST0: counted in bytes).
_SIZE = {**dict.fromkeys(("X_ACTIVE", "S_OCC", "S_TOUCH", "K_ACTIVE", "P_SRC0", "P_DST0"), 1),
         "S_INV": 12, "P_PERM": 8}


def lane_bytes(kernel: str, counts: dict) -> int:
    """The bytes a launch of ``kernel`` must move: each lane column of
    :data:`MOVES` once in each pass over the lanes that ``counts`` gives it
    (None: every lane, ``counts[None]``).  A bytes bound's numerator."""
    return sum(counts.get(cond, 0) * _SIZE.get(slot, 4) for slot, cond in MOVES[kernel].items())


class _Launch(_ext.Columns):
    """A trace kernel's launch (:class:`_ext.Columns` over :data:`SLOTS` and
    :data:`INTS`, and the floats of :data:`REALS`)."""

    def __init__(self, n: int, device):
        super().__init__(_SLOT, _INT, n, device, "trace")
        self.reals = (ctypes.c_float * len(REALS))()

    def real(self, name: str, value: float) -> None:
        """Float ``name``: ``value`` rounded to float32 as aten rounds a
        Python float."""
        self.reals[_REAL[name]] = float(value)

    def rays(self, names, rays) -> None:
        for name, c in zip(names, rays):
            self.lane(name, c)

    def run(self, kernel: str, counter: str | None = None) -> None:
        _ext.launch(f"{kernel}_launch", self.device, ctypes.addressof(self.ptrs),
                    ctypes.addressof(self.ints), ctypes.addressof(self.reals))
        LAUNCHES[counter or kernel] += 1


def _on_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the trace kernels run on cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


def lanes(x, n, device):
    """``x`` (a number or a tensor) as (n,) float32 lanes on ``device``.  A
    number is filled on the device: made on the host, it would be copied
    over with a synchronisation."""
    if isinstance(x, (int, float)):
        return torch.full((n,), x, dtype=_F32, device=device)
    return torch.broadcast_to(torch.as_tensor(x, dtype=_F32, device=device), (n,))


# ---------------------------------------------------------------------------
# The closest hit's finish (pallas_dense.py:282-298, pallas_bvh.py:1309-1350,
# instanced.py:236-262)
# ---------------------------------------------------------------------------


def winner_uv(tables, o: V3, d: V3, tri):
    """Barycentric (u, v) of each lane's winning triangle, recomputed from 9
    flat gathers (pallas_dense.py:282-292); lanes with tri < 0 read tri 0."""
    ti = torch.clamp_min(tri, 0)
    wv0 = v3_gather(tables.v0, ti)
    e1 = v3_gather(tables.v1, ti) - wv0
    e2 = v3_gather(tables.v2, ti) - wv0
    pvec = d.cross(e2)
    det = e1.dot(pvec)
    inv = torch.reciprocal(torch.where(torch.abs(det) < 1e-12, 1.0, det))
    tvec = o - wv0
    return tvec.dot(pvec) * inv, d.dot(tvec.cross(e1)) * inv


def slot_to_tri(s, slot):
    """Scene triangle of each lane's slot, a row of the shared triangle table
    of the BVH streams ``s`` (``_slot_to_tri`` pallas_bvh.py:1343).  Returns
    (tri, found)."""
    found = slot >= 0
    tri = s.tri_id[torch.clamp_min(slot, 0).long()]
    return torch.where(found, tri, -1), found


def _apply_affine(m, p: V3) -> V3:
    """3x4 row-major affine transform of points; ``m`` holds 12 numbers,
    0-d or (N,) tensors (a (12,) row holds 0-d ones)."""
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


def _instanced_finish(tables, o: V3, d: V3, t_best, enc):
    """(t, enc, u, v) of an instanced scan's winner: (u, v) once, for the
    winning (instance, triangle), in its object space (instanced.py:236-262)."""
    inst = tables.inst
    found = enc >= 0
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


def hit_finish_reference(tables, rays, t, hit, mode: str):
    """The closest hit (t, tri, u, v) after a traversal launch that found
    (``t``, ``hit``) for the rays ``rays`` (six float32 columns: o.xyz,
    d.xyz).  ``mode`` says what ``hit`` holds: "dense", a triangle (K1);
    "bvh", a slot of ``tables.pbvh`` (K4'/K5'); "instanced", an encoded id
    after an instance scan.  t = inf, tri = -1 and u = v = 0 on a miss."""
    o, d = V3(*rays[:3]), V3(*rays[3:])
    if mode == "instanced":
        return _instanced_finish(tables, o, d, t, hit)
    if mode == "bvh":
        tri, found = slot_to_tri(tables.pbvh, hit)
    else:
        tri, found = hit, hit >= 0
    u, v = winner_uv(tables, o, d, tri)
    return (
        torch.where(found, t, torch.inf),
        tri,
        torch.where(found, u, 0.0),
        torch.where(found, v, 0.0),
    )


def hit_finish(tables, rays, t, hit, mode: str):
    """The closest hit's finish; see :func:`hit_finish_reference`."""
    if not _on_cuda(hit):
        return hit_finish_reference(tables, rays, t, hit, mode)
    n = hit.shape[0]
    k = _Launch(n, hit.device)
    k.rays(_RAYS, rays)
    k.lane("H_T", t)
    k.lane("H_HIT", hit, torch.int32)
    for name, v in (("T_V0", tables.v0), ("T_V1", tables.v1), ("T_V2", tables.v2)):
        for c, x in zip("XYZ", v):
            k.put(name + c, x, _F32)
    k.count("I_MODE", FINISH_MODES.index(mode))
    if mode == "bvh":
        k.put("T_TRIID", tables.pbvh.tri_id, torch.int32)
    elif mode == "instanced":
        k.put("T_INVFLAT", tables.inst.inv_flat, _F32)
        k.count("I_PROTO_TRIS", tables.inst.num_proto_tris)
        k.count("I_NUM_INST", tables.inst.num_instances)
    out = torch.empty((3, n), dtype=_F32, device=k.device).unbind(0)
    tri = torch.empty(n, dtype=torch.int32, device=k.device)
    for name, c in (("O_T", out[0]), ("O_U", out[1]), ("O_V", out[2])):
        k.lane(name, c)
    k.lane("O_TRI", tri, torch.int32)
    k.run("hit_finish")
    return out[0], tri, out[1], out[2]


def hit_finish_bytes(hit, tables=None, mode: str | None = None) -> int:
    """The bytes one :func:`hit_finish` of the traversal's ``hit`` must
    move (:func:`lane_bytes`): the hit and the four outputs on every lane,
    t and the ray where something was hit; with ``tables`` and ``mode``,
    the table rows those hits read too (:func:`finish_table_bytes`)."""
    lanes = lane_bytes("hit_finish", {None: hit.numel(), "found": int((hit >= 0).sum())})
    return lanes + (0 if tables is None else finish_table_bytes(tables, hit, mode))


#: Bytes of the finish's table rows (``FINISH_ROWS`` below): a triangle's
#: nine vertex floats, a BVH slot's triangle, an instance's 12 map values.
FINISH_ROW_BYTES = {"vertices": 36, "slot": 4, "instance": 48}


def finish_table_bytes(tables, hit, mode: str) -> int:
    """The table bytes the finish of the lanes ``hit`` (one traversal's ids,
    of :data:`FINISH_MODES` ``mode``) must read, each row once however many
    lanes hit it: the slots' triangles (``"bvh"``), the instances' maps
    (``"instanced"``) and the hit triangles' vertices.  A finish loads them
    once a found lane."""
    found = hit[hit >= 0].long()
    n = 0
    if mode == "bvh":
        n += FINISH_ROW_BYTES["slot"] * int(found.unique().numel())
        found = tables.pbvh.tri_id.long()[found]
    elif mode == "instanced":
        found, inst = tables.inst.decode(found)
        inst = torch.clamp_max(inst, tables.inst.num_instances - 1)
        n += FINISH_ROW_BYTES["instance"] * int(inst.unique().numel())
    return n + FINISH_ROW_BYTES["vertices"] * int(found.unique().numel())


# ---------------------------------------------------------------------------
# The instance scans (instanced.py:185-234, :279-317)
# ---------------------------------------------------------------------------


def ray_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test of (N, 3) rays against one box: does [t_min, t_max] meet
    the box interval?  (``ray_aabb``, vulkan_raytracer_tpu/ops/intersect.py:31)"""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(dim=-1)
    tfar = torch.maximum(t0, t1).amin(dim=-1)
    return (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_max)


def instance_state(n: int, device, *, shadow: bool, t_lo: bool) -> dict:
    """The running state of one instanced call's scan: on a card its
    buffers, which every :func:`instance_step` of the call writes over
    (``inv`` (n, 3) 1/d; ``t_best`` and ``enc``, or ``occ``; the lanes that
    touch the next instance's box, ``touches``; the next launch's ``rays``
    and ``t_init``; its ``t_lo`` with ``t_lo``); on the CPU nothing: the
    plain steps make their own."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    rows = torch.empty((8 + t_lo, n), dtype=_F32, device=device).unbind(0)
    flags = torch.empty((2, n), dtype=torch.bool, device=device).unbind(0)
    st = {"inv": torch.empty((n, 3), dtype=_F32, device=device), "rays": tuple(rows[:6]),
          "t_init": rows[6], "touches": flags[1]}
    if shadow:
        st["occ"] = flags[0]
    else:
        st.update(t_best=rows[7], enc=torch.empty(n, dtype=torch.int32, device=device))
    if t_lo:
        st["t_lo"] = rows[-1]
    return st


def instance_step_reference(tables, st: dict, rays, active, t_max, t_min, prev, nxt,
                            shadow: bool, word=None) -> dict:
    """One step of an instance scan (instanced.py:185-234; the shadow scan
    :279-317): the call's state after it, from the state ``st`` before it.

    ``rays`` are the call's six world ray columns, ``active`` its lanes,
    ``t_max`` its bound (a number or per lane).  The call's first step
    (``prev`` None) makes the state: 1/d, and the closest scan's ``t_best``
    (``t_max``, 0 on inactive lanes: no box or triangle passes) and ``enc``
    (-1), or the shadow scan's ``occ``; and ``t_lo``, ``t_min`` on every
    lane, where ``t_min`` is a number.  Then ``prev`` = (instance, t, hit),
    the last instance's launch, is merged on the lanes that touched its box
    (``touches``; elsewhere its result is not read, since a launch that no
    lane touched may not have run): a hit strictly closer than ``t_best``
    replaces it (the first instance in DFS order keeps an exact tie) with
    its encoded id ``instance * num_proto_tris + proto_tri``, or an
    occluding hit sets ``occ``.  Then for the instance ``nxt``: the lanes
    whose ray meets its world box within the bound (the shadow scan: still
    unoccluded), ``touches``, the rays in its object space and its
    launch's ``t_init``, the bound on those lanes and else 0 for the dense
    sweeps, -1 for a BLAS walk.  Without ``nxt`` (the call's last
    step) the shadow scan's ``occ`` is masked by ``active``.  An instance
    is ``(group, m, iid, bmin, bmax)``: its group, its 12 world->object
    values, its id and its box (views of the group's rows; the plain
    version takes numbers as well).  ``word``, the next launch's IF control
    block that the kernel counts into, is not read here: the host-read
    replay counts ``touches`` itself."""
    o, d = V3(*rays[:3]), V3(*rays[3:])
    n, dev = active.shape[0], active.device
    st = dict(st)
    if prev is None:
        st["inv"] = safe_inv_dir(d.to_array())
        if shadow:
            st["occ"] = torch.zeros(n, dtype=torch.bool, device=dev)
        else:
            st["t_best"] = torch.where(active, lanes(t_max, n, dev), 0.0)
            st["enc"] = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if t_min is not None:
            st["t_lo"] = lanes(t_min, n, dev).contiguous()
    else:
        x, t_n, hit = prev
        g = x.group
        touched = st["touches"]
        if shadow:
            found = hit >= 0 if g.pblas is not None else hit != 0
            st["occ"] = st["occ"] | (found & touched)
        else:
            hit = torch.where(touched, hit, -1)
            local = hit if g.pblas is None else slot_to_tri(g.pblas, hit)[0]
            closer = touched & (local >= 0) & (t_n < st["t_best"])
            st["t_best"] = torch.where(closer, t_n, st["t_best"])
            st["enc"] = torch.where(
                closer, local + (x.iid * tables.inst.num_proto_tris + g.tri_off), st["enc"])
    if nxt is None:
        if shadow:
            st["occ"] = st["occ"] & active
        return st
    if shadow:
        # a dead lane's bound 0 would pass the box where its origin lies inside
        bound = lanes(t_max, n, dev)
        touches = (active & ~st["occ"]) & ray_aabb(o.to_array(), st["inv"], nxt.bmin, nxt.bmax,
                                                   0.0, bound)
    else:
        bound = st["t_best"]
        touches = active & ray_aabb(o.to_array(), st["inv"], nxt.bmin, nxt.bmax, 0.0, bound)
    st["touches"] = touches
    st["rays"] = tuple(c.contiguous() for c in (*_apply_affine(nxt.m, o),
                                                 *_apply_linear(nxt.m, d)))
    st["t_init"] = torch.where(touches, bound, 0.0 if nxt.group.pblas is None else -1.0)
    return st


def instance_step(tables, st: dict, rays, active, t_max, t_min, prev, nxt, shadow: bool,
                  word=None) -> dict:
    """One step of an instance scan; see :func:`instance_step_reference`.
    On a card the kernel writes the next state over ``st``'s buffers
    (:func:`instance_state`) and returns ``st``; it reads the instances'
    values, ids and boxes through pointers into their groups' rows.  Given
    ``word``, the next launch's IF control block (four int64, the layout of
    ``wave.LOOP_WORDS``; a program's, ``render/graphs.py``), it also counts
    the lanes that touch the next instance's box into it and, where the
    program armed it on the card, sets the IF.  The plain version has no
    use for it: the host-read replay counts ``touches`` itself."""
    if not _on_cuda(active):
        return instance_step_reference(tables, st, rays, active, t_max, t_min, prev, nxt, shadow)
    n = active.shape[0]
    k = _Launch(n, active.device)
    k.rays(_RAYS, rays)
    k.lane("X_ACTIVE", active, torch.bool)
    if isinstance(t_max, torch.Tensor):
        k.lane("X_TMAX", t_max)
    else:
        k.real("F_TMAX", t_max)
    k.put("S_INV", st["inv"], _F32, (n, 3))
    k.lane("S_TOUCH", st["touches"], torch.bool)
    if shadow:
        k.lane("S_OCC", st["occ"], torch.bool)
    else:
        k.lane("S_TBEST", st["t_best"])
        k.lane("S_ENC", st["enc"], torch.int32)
    k.rays(_NEXT, st["rays"])
    k.lane("N_TINIT", st["t_init"])
    k.count("I_SHADOW", shadow)
    k.count("I_PROTO_TRIS", tables.inst.num_proto_tris)
    if prev is None:
        k.count("I_FIRST", 1)
        if t_min is not None:
            k.lane("N_TLO", st["t_lo"])
            k.real("F_TMIN", t_min)
    else:
        x, t_n, hit = prev
        k.count("I_PREV", 1)
        k.lane("H_HIT", hit, torch.int32)
        if not shadow:
            k.lane("H_T", t_n)
            k.put("X_IID", x.iid, torch.int32, ())
            k.count("I_TRI_OFF", x.group.tri_off)
        if x.group.pblas is not None:
            k.count("I_PREV_BLAS", 1)
            k.put("T_TRIID", x.group.pblas.tri_id, torch.int32)
    if nxt is not None:
        k.count("I_NEXT", 1)
        k.count("I_NEXT_BLAS", nxt.group.pblas is not None)
        k.put("X_M", nxt.m, _F32, (12,))
        k.put("X_BMIN", nxt.bmin, _F32, (3,))
        k.put("X_BMAX", nxt.bmax, _F32, (3,))
        if word is not None:
            k.put("X_IF", word, torch.int64, (4,))
    k.run("instance_step")
    return st


def instance_step_bytes(n: int, *, first: bool, prev: bool, nxt: bool, shadow: bool,
                        t_max_lanes: bool, t_lo: bool, touched: int | None = None) -> int:
    """The bytes one :func:`instance_step` over ``n`` lanes must move
    (:func:`lane_bytes`): the lanes' flag and 1/d (written by the first
    step, else read), the bound where it is per lane, the running state
    written and, after the first step, read; the touched flags read by a
    merge and written for a next instance; the last launch's result on the
    ``touched`` lanes of a merge (every lane: ``n``); the direction (first
    step or a next instance), and for a next instance the origin and its
    rays and bound written."""
    passes = n * (1 if first else 2)
    touched = n if touched is None else touched
    return lane_bytes("instance_step", {
        None: n, "t_max_lanes": n * t_max_lanes, "next": n * nxt,
        "first_or_next": n * (first or nxt), "closest_state": 0 if shadow else passes,
        "shadow_state": passes if shadow else 0, "touches": n * (prev + nxt),
        "touched": touched * prev, "touched_closest": touched * (prev and not shadow),
        "t_lo": n * (first and t_lo)})


# ---------------------------------------------------------------------------
# The coherence key (integrator.py:307-349)
# ---------------------------------------------------------------------------


def _morton6(x):
    """Interleave the low 6 bits of x into every third bit (integrator.py:307-313)."""
    out = torch.zeros_like(x)
    for i in range(6):
        out = out | (((x >> i) & 1) << (3 * i))
    return out


@functools.lru_cache(maxsize=8)
def _morton_table(device) -> torch.Tensor:
    """:func:`_morton6` of 0..63 as a table on ``device``, one gather a cell."""
    return _morton6(torch.arange(64, dtype=torch.int32, device=device))


def root_bounds(tables):
    """(lo, hi), the (3,) bounds the key's cells divide: the BVH root's, or
    on an instanced scene the union of the instance boxes, reduced here (a
    few torch ops: JAX ``_coherence_key``'s reductions, kept by the plain
    version; the kernel reads the same pair from :func:`key_box`)."""
    if tables.inst is not None:
        lo = torch.stack([g.aabb_min.amin(0) for g in tables.inst.groups]).amin(0)
        hi = torch.stack([g.aabb_max.amax(0) for g in tables.inst.groups]).amax(0)
        return lo, hi
    return tables.bvh.aabb_min[0], tables.bvh.aabb_max[0]


def key_box(tables):
    """(lo, hi) as :func:`coherence_key` hands them to its kernel: views of
    the BVH root's box, or of the instanced tables' union box
    (``InstanceTables.box``, made with the instance boxes at upload and at
    refit, so a program's mirror of a refit's tables holds the new box).
    Bit-equal to :func:`root_bounds`; no op runs."""
    if tables.inst is not None:
        return tables.inst.box[0], tables.inst.box[1]
    return tables.bvh.aabb_min[0], tables.bvh.aabb_max[0]


def coherence_key_reference(tables, o: V3, d: V3, active):
    """(dead, direction octant, Morton cell of the origin) as one int32 per
    lane, ``dead << 30 | octant << 27 | morton << 9`` (integrator.py:316-349),
    dead = not ``active``.  The cells are 64 per axis over
    :func:`root_bounds`."""
    lo, hi = root_bounds(tables)
    dead = ~active
    scale = 64.0 / torch.clamp_min(hi - lo, 1e-20)
    cells = torch.clamp((torch.stack(o) - lo[:, None]) * scale[:, None], 0.0, 63.0)
    m = _morton_table(o.x.device)[cells.to(torch.int32)]  # (3, N): x, y, z
    neg = (torch.stack(d) < 0).to(torch.int32)
    key = (((m[0] << 2) | (m[1] << 1) | m[2]) << 9) | (neg[0] << 29) | (neg[1] << 28)
    return key | (neg[2] << 27) | (dead.to(torch.int32) << 30)


def coherence_key(tables, o: V3, d: V3, active):
    """The re-sort key of each lane; see :func:`coherence_key_reference`.
    On a card one launch, over :func:`key_box`, and nothing else."""
    if not _on_cuda(active):
        return coherence_key_reference(tables, o, d, active)
    lo, hi = key_box(tables)
    n = active.shape[0]
    k = _Launch(n, active.device)
    k.rays(_RAYS, (*o, *d))
    k.put("K_LO", lo, _F32, (3,))
    k.put("K_HI", hi, _F32, (3,))
    k.lane("K_ACTIVE", active, torch.bool)
    key = torch.empty(n, dtype=torch.int32, device=k.device)
    k.lane("K_KEY", key, torch.int32)
    k.run("coherence_key")
    return key


def coherence_key_bytes(n: int) -> int:
    """The bytes one :func:`coherence_key` over ``n`` lanes must move
    (:func:`lane_bytes`): the ray and the flag read, the key written."""
    return lane_bytes("coherence_key", {None: n})


# ---------------------------------------------------------------------------
# The re-sort's gathers, scatters and copies (integrator.py:234-267, 352-373)
# ---------------------------------------------------------------------------


def permute_reference(cols, perm=None, mode: str = "gather", out=None) -> list:
    """The columns ``cols`` (1-D, one element a lane) by the permutation
    ``perm`` (int64): "gather", new columns ``dst[i] = src[perm[i]]``
    (``index_select``); "scatter", new columns ``dst[perm[i]] = src[i]``
    (``index_copy_``); "copy", each column copied into its ``out`` (no
    ``perm``).  Returns the new columns, or ``out``."""
    if mode == "gather":
        return [torch.index_select(c, 0, perm) for c in cols]
    if mode == "scatter":
        return [torch.empty_like(c).index_copy_(0, perm, c) for c in cols]
    for dst, src in zip(out, cols):
        dst.copy_(src)
    return list(out)


def permute(cols, perm=None, mode: str = "gather", out=None) -> list:
    """Every column moved by one permutation; see :func:`permute_reference`.
    On a card one launch moves up to :data:`MAX_COLS` columns (a wave
    state has 21) of 1, 4 or 8 bytes an element; a gather or a scatter
    writes new columns (it cannot run in place), a copy writes ``out``."""
    cols = list(cols)
    if not cols:
        return [] if out is None else list(out)
    if not _on_cuda(cols[0]):
        return permute_reference(cols, perm, mode, out)
    if len(cols) > MAX_COLS:
        raise ValueError(f"permute moves at most {MAX_COLS} columns a launch, not {len(cols)}")
    n = cols[0].shape[0]
    k = _Launch(n, cols[0].device)
    k.count("I_MODE", PERMUTE_MODES.index(mode))
    if mode == "copy":
        out = list(out)
    else:
        out = [torch.empty_like(c, memory_format=torch.contiguous_format) for c in cols]
        k.put("P_PERM", perm, torch.int64, (n,))
    for j, (src, dst) in enumerate(zip(cols, out)):
        if src.element_size() not in (1, 4, 8):
            raise ValueError(f"permute moves columns of 1, 4 or 8 bytes an element, "
                             f"not {src.dtype}")
        k.lane(f"P_SRC{j}", src, src.dtype)
        k.lane(f"P_DST{j}", dst, src.dtype)
        k.count(f"I_WIDTH{j}", src.element_size())
    k.count("I_COLS", len(cols))
    k.run("permute", "permute_copy" if mode == "copy" else "permute")
    return out


def permute_bytes(cols, mode: str) -> int:
    """The bytes one :func:`permute` of ``cols`` must move
    (:func:`lane_bytes`): each column read and written once, and the
    permutation."""
    n = cols[0].shape[0]
    return lane_bytes("permute", {"perm": 0 if mode == "copy" else n,
                                  "cols": sum(c.numel() * c.element_size() for c in cols)})
