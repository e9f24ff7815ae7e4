"""Threaded-BVH walks: closest hit and occlusion for scenes on the BVH path.

The port's counterpart of the two Pallas BVH kernels of
``vulkan_raytracer_tpu/ops/pallas_bvh.py`` and named after their XLA twin,
``vulkan_raytracer_tpu/ops/traverse.py``:

* K4 ``_kernel`` (:425, through ``_packet_sweep`` :672 and
  ``_plain_sweep_pb`` :1655) walks a whole per-octant stream -> here the
  *whole-stream walk* :func:`bvh_walk` (CUDA ``bvh_walk_kernel``);
* K5 ``_wkernel`` (:727, through ``_windowed_sweep_call`` :1023 and
  ``_windowed_sweep`` :1225, fed by the XLA ``_window_glue`` :1096) walks the
  treelets a ray enters, front to back -> here the *treelet walk*
  :func:`treelet_walk` (CUDA ``treelet_walk_kernel``).

Each walk has a hand-written CUDA kernel (``csrc/bvh_walk.cu``), launched for
CUDA tensors and counted in :data:`LAUNCHES`, and a plain PyTorch version
(``*_reference``): a lockstep, vectorised walk over the same streams with the
same arithmetic and the same visit order per ray, which runs for CPU tensors
and which the tests and ``chip_smoke.py`` hold the kernels against.  There is
no fallback: on CUDA tensors a build or launch error raises.

Only the contract of the TPU kernels is kept; their tiles, shared beams,
SMEM scalar broadcasts and DMA chunks (pallas_bvh.py:1-66) are not.  One
thread walks one ray:

* the ray's own octant (bit k set <=> d[k] < 0; -0.0 counts as positive, as
  in JAX) picks the near-child-first stream, where K4 used its tile's mean
  direction (:404-421);
* a node is entered when the ray's slab interval meets [0, t_best].  The
  slab test is per ray, with the ``_inv_comp`` reciprocal (:1352), so no NaN
  arises; its far end and the t bound are scaled by ``ROBUST`` = 1 + 2
  gamma_3 (Ize, "Robust BVH Ray Traversal", JCGT 2013) so that rounding
  never culls a box the ray touches (the ground plane's box is flat);
* a leaf runs ``leaf_size`` Möller-Trumbore tests with the arithmetic of
  :614-636 (``dense.mt``); a hit is ``t_lo < t <= t_best``; the closest walk
  replaces when ``t < t_best`` or nothing hit yet (the first triangle
  visited wins a tie, :644); the shadow walk ends at its first hit with
  t_best = -1 (:637-646);
* the treelet walk first slab-tests the ray against every treelet box
  (the glue's exact per-ray test, :1120-1140: enters when ``near <= far``,
  ``far >= t_lo`` and ``near <= t_init``, at ``entry = max(near, 0)``), then
  walks the entered treelets in ascending (entry, treelet id), each one's
  range ``tl_lim[octant, k]`` of the stream, and stops when the next entry
  is > t_best (strictly: a hit at exactly the initial bound is still found).

So both walks find the closest hit over every triangle; they differ only at
exact-t ties.  Dispatch is the JAX rule: the treelet walk when the streams
have more than one treelet (``_windowed_enabled`` :1178), else the
whole-stream walk.

The stream builder is ``_build_streams`` (:144) and ``_cut_tables`` (:214)
with an explicit ``max_tris`` (2048, the JAX default off the TPU; the TPU's
upload-time probe ``_probe_treelet_cut`` :291 is not ported) in the port's
own row-major layout for the card; the content is the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _ext
from .dense import _lanes, _on_cuda, mt, ray_columns, winner_uv

#: default target triangle slots per treelet (pallas_bvh.py:141)
TREELET_TRIS = 2048
#: cap on treelets per stream (pallas_bvh.py:135); the CUDA treelet walk
#: keeps one entry per treelet in a fixed per-thread array of this size
MAX_TREELETS = 128
#: 1 + 2 gamma_3 in float32 (1 + 3 * 2^-23): the conservative scale of a slab
#: test's far end and t bound (Ize 2013)
ROBUST = 1.0 + 3.0 * 2.0**-23
_TINY = 1e-30

#: Kernel launches since the last reset, by kernel and variant.
LAUNCHES = {"bvh_closest": 0, "bvh_shadow": 0, "treelet_closest": 0, "treelet_shadow": 0}

_F32 = torch.float32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BVHStreams:
    """Eight per-octant preorders of one threaded BVH (octant bit k set <=>
    d[k] < 0), in the CUDA walks' row-major layout.  The content is the JAX
    ``PacketBVH``'s (pallas_bvh.py:96-122) without its TPU padding: node
    ``i`` of octant ``o`` is row ``(o, i)``; ``first_leaf`` is the
    octant-local leaf index (-1 for an interior node) and ``miss`` the
    stream-local skip pointer; leaf ``l``'s row holds its triangles'
    [v0.xyz, e1.xyz, e2.xyz] at columns ``9 j + c``; ``tri_id[o, l * k + j]``
    is the scene triangle of slot ``j`` of leaf ``l`` (-1 padding)."""

    nodes_f: torch.Tensor  # (8, Nn, 6) f32: bmin.xyz, bmax.xyz
    nodes_i: torch.Tensor  # (8, Nn, 2) i32: first_leaf, miss
    leaves: torch.Tensor  # (8, Nleaf, 9 * leaf_size) f32
    tri_id: torch.Tensor  # (8, Nleaf * leaf_size) i32
    tl_box: torch.Tensor  # (K, 6) f32 treelet boxes, slightly dilated
    tl_lim: torch.Tensor  # (8, K, 2) i32 per-octant stream range [start, end)
    num_nodes: int
    leaf_size: int
    n_treelets: int

    @property
    def n_leaves(self) -> int:
        return self.leaves.shape[1]

    def to(self, device) -> "BVHStreams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.type == "torch.Tensor"
        })


def build_streams(bvh, max_tris: int = TREELET_TRIS,
                  max_treelets: int = MAX_TREELETS) -> BVHStreams:
    """Repack a ThreadedBVH (the port's, or any record with the same fields)
    into eight per-octant streams and a treelet cut of at most
    ``max_treelets`` subtrees of about ``max_tris`` triangle slots
    (``_build_streams`` :144 and ``_cut_tables`` :214).  Host-side NumPy;
    returns CPU tensors."""
    from ..accel.bvh import octant_permutations, treelet_cut

    k = bvh.leaf_size
    if bvh.num_tri_slots >= 2**24 or bvh.num_nodes >= 2**24:
        raise ValueError("BVH stream indices exceed the 2^24 guard")
    if max_treelets > MAX_TREELETS:
        raise ValueError(f"the treelet walk takes at most {MAX_TREELETS} treelets")

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    amin, amax = host(bvh.aabb_min), host(bvh.aabb_max)
    first, miss, tri_id = host(bvh.first_tri), host(bvh.miss), host(bvh.tri_id)
    n = first.shape[0]
    size = miss - np.arange(n)
    first_leaf = np.where(first >= 0, first // k, -1)
    # (Nleaf, 9k) leaf-major triangle constants in the original leaf order
    tri9 = np.concatenate(
        [host(bvh.tri_v0), host(bvh.tri_e1), host(bvh.tri_e2)], axis=1
    ).reshape(-1, k * 9)

    perms = octant_permutations(amin, amax, first, miss)
    pos8 = np.empty((8, n), np.int64)  # old node index -> stream position
    nf, ni, lv, tid = [], [], [], []
    for o in range(8):
        old = perms[o]  # new node index -> old node index
        pos8[o, old] = np.arange(n)
        fl_old = first_leaf[old]
        leafmask = fl_old >= 0
        # leaves renumbered along this octant's preorder
        fl_new = np.where(leafmask, np.cumsum(leafmask) - 1, -1)
        leaf_perm = fl_old[leafmask]  # new leaf index -> old leaf index
        nf.append(np.concatenate([amin[old], amax[old]], axis=1).astype(np.float32))
        ni.append(np.stack([fl_new, np.arange(n) + size[old]], axis=1).astype(np.int32))
        lv.append(tri9[leaf_perm].astype(np.float32))
        tid.append(tri_id.reshape(-1, k)[leaf_perm].reshape(-1).astype(np.int32))

    max_tris = max(int(max_tris), k)
    cut = treelet_cut(first, miss, k, max_tris)
    while cut.shape[0] > max_treelets:
        max_tris *= 2
        cut = treelet_cut(first, miss, k, max_tris)
    ext = amax[cut] - amin[cut]
    eps = 1e-5 * np.maximum(ext.max(axis=1, keepdims=True), 1e-3) + 1e-7
    tl_box = np.concatenate([amin[cut] - eps, amax[cut] + eps], axis=1).astype(np.float32)
    tl_lim = np.stack([pos8[:, cut], pos8[:, cut] + size[cut]], axis=-1).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    return BVHStreams(
        nodes_f=t(np.stack(nf)), nodes_i=t(np.stack(ni)), leaves=t(np.stack(lv)),
        tri_id=t(np.stack(tid)), tl_box=t(tl_box), tl_lim=t(tl_lim),
        num_nodes=n, leaf_size=k, n_treelets=int(cut.shape[0]),
    )


# ---------------------------------------------------------------------------
# Per-ray quantities shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def octant(rays) -> torch.Tensor:
    """Each ray's stream: bit k set <=> d[k] < 0 (int64)."""
    dx, dy, dz = rays[3:]
    return (dx < 0).long() + 2 * (dy < 0).long() + 4 * (dz < 0).long()


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-30 replaced by a signed 1e-30 (``_inv_comp``)."""
    return torch.reciprocal(torch.where(
        torch.abs(d) < _TINY, torch.where(d < 0, -_TINY, _TINY), d))


def treelet_entries(streams: BVHStreams, rays, t_lo, t_init):
    """The glue's per-ray treelet test (pallas_bvh.py:1120-1140): (N, K)
    ``enters`` and ``entry`` = max(near, 0), written so that a zero entry is
    +0.0 (a radix sort puts -0.0 first)."""
    o = rays[:3]
    inv = [inv_dir(c) for c in rays[3:]]
    box = streams.tl_box
    near = far = None
    for a in range(3):
        lo = (box[None, :, a] - o[a][:, None]) * inv[a][:, None]
        hi = (box[None, :, a + 3] - o[a][:, None]) * inv[a][:, None]
        n_a, f_a = torch.minimum(lo, hi), torch.maximum(lo, hi)
        near = n_a if near is None else torch.maximum(near, n_a)
        far = f_a if far is None else torch.minimum(far, f_a)
    enters = ((t_init >= 0)[:, None] & (near <= far) & (far >= t_lo[:, None])
              & (near <= t_init[:, None]))
    return enters, torch.where(near > 0, near, 0.0)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: lockstep walks
# ---------------------------------------------------------------------------

# columns of the walk state (compacted to the lanes still walking)
_OX, _IV, _LO, _TB = 0, 6, 9, 10  # float: o.xyz d.xyz, inv.xyz, t_lo, t_best
_LANE, _CUR, _END, _OCT, _SLOT, _RND = range(6)  # int64
#: rays per block of the (N, K) treelet-order computation
_ORDER_BLOCK = 1 << 15


def _walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool, treelets: bool):
    n = t_init.shape[0]
    dev = t_init.device
    t_out = t_init.clone()
    slot_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lanes = torch.nonzero(t_init >= 0).squeeze(1)
    if lanes.numel() == 0:
        return t_out, slot_out
    k = s.leaf_size
    nodes_f = s.nodes_f.reshape(-1, 6)
    nodes_i = s.nodes_i.reshape(-1, 2).long()
    leaves = s.leaves.reshape(-1, k, 9)
    slot_ids = torch.arange(k, device=dev)

    cols = [c[lanes] for c in rays]
    oc = octant(cols)
    fs = torch.stack(cols + [inv_dir(c) for c in cols[3:]] + [t_lo[lanes], t_init[lanes]], 1)
    zero = torch.zeros_like(lanes)
    end = zero if treelets else torch.full_like(lanes, s.num_nodes)
    ints = torch.stack([lanes, zero, end, oc, zero - 1, zero], 1)

    if treelets:
        # each lane's entered treelets in ascending (entry, id), by lane id
        order = torch.empty((n, s.n_treelets), dtype=torch.int64, device=dev)
        entry = torch.empty((n, s.n_treelets), dtype=_F32, device=dev)
        n_entered = torch.zeros(n, dtype=torch.int64, device=dev)
        for b in range(0, lanes.numel(), _ORDER_BLOCK):
            blk = lanes[b:b + _ORDER_BLOCK]
            enters, ent = treelet_entries(s, [c[blk] for c in rays], t_lo[blk], t_init[blk])
            ent, order[blk] = torch.sort(torch.where(enters, ent, torch.inf), dim=1,
                                         stable=True)
            entry[blk] = ent
            n_entered[blk] = enters.sum(1)
        tl_lim = s.tl_lim.reshape(-1, 2).long()

    while True:
        if treelets:  # lanes past their treelet take the next one, or stop
            nxt = torch.nonzero(ints[:, _CUR] >= ints[:, _END]).squeeze(1)
            lane, rnd = ints[nxt, _LANE], ints[nxt, _RND]
            r = torch.clamp_max(rnd, s.n_treelets - 1)
            go = (rnd < n_entered[lane]) & ~(entry[lane, r] > fs[nxt, _TB])
            lim = tl_lim[ints[nxt, _OCT] * s.n_treelets + order[lane, r]]
            ints[nxt, _CUR] = torch.where(go, lim[:, 0], ints[nxt, _CUR])
            ints[nxt, _END] = torch.where(go, lim[:, 1], ints[nxt, _END])
            ints[nxt, _RND] = rnd + 1
        done = ints[:, _CUR] >= ints[:, _END]
        if bool(done.any()):
            fin = done.nonzero().squeeze(1)
            t_out[ints[fin, _LANE]] = fs[fin, _TB]
            slot_out[ints[fin, _LANE]] = ints[fin, _SLOT].int()
            keep = ~done
            fs, ints = fs[keep], ints[keep]
        if ints.shape[0] == 0:
            return t_out, slot_out

        # one node per lane: slab test against [0, t_best]
        cur = ints[:, _CUR]
        node = ints[:, _OCT] * s.num_nodes + cur
        box = nodes_f[node]
        o, inv = fs[:, _OX:_OX + 3], fs[:, _IV:_IV + 3]
        lo = (box[:, 0:3] - o) * inv
        hi = (box[:, 3:6] - o) * inv
        near3, far3 = torch.minimum(lo, hi), torch.maximum(lo, hi)
        near = torch.maximum(torch.maximum(near3[:, 0], near3[:, 1]),
                             torch.clamp_min(near3[:, 2], 0.0))
        far = torch.minimum(torch.minimum(far3[:, 0], far3[:, 1]), far3[:, 2])
        t_best = fs[:, _TB]
        hit = (near <= far * ROBUST) & (near <= t_best * ROBUST)
        ni = nodes_i[node]
        leaf = hit & (ni[:, 0] >= 0)

        if bool(leaf.any()):
            li = leaf.nonzero().squeeze(1)
            fl = ni[li, 0]
            tri = leaves[ints[li, _OCT] * s.n_leaves + fl]  # (L, k, 9)
            ray = [fs[li, c, None] for c in range(6)]
            inside, _, _, tt = mt([tri[..., c] for c in range(9)], ray)
            tb = fs[li, _TB]
            h = inside & (tt > fs[li, _LO, None]) & (tt <= tb[:, None])
            any_h = h.any(1)
            slot = ints[li, _SLOT]
            if shadow:  # the first hit occludes and ends the walk
                first = h.int().argmax(1)
                fs[li, _TB] = torch.where(any_h, -1.0, tb)
                ints[li, _SLOT] = torch.where(any_h, fl * k + first, slot)
                ints[li, _END] = torch.where(any_h, -1, ints[li, _END])
                if treelets:
                    ints[li, _RND] = torch.where(any_h, s.n_treelets, ints[li, _RND])
            else:  # the least t; among equal t the first slot (the kernel's order)
                t_min = torch.where(h, tt, torch.inf).amin(1)
                first = torch.where(h & (tt == t_min[:, None]), slot_ids, k).amin(1)
                rep = any_h & ((t_min < tb) | (slot < 0))
                fs[li, _TB] = torch.where(rep, t_min, tb)
                ints[li, _SLOT] = torch.where(rep, fl * k + first, slot)

        ints[:, _CUR] = torch.where(hit, cur + 1, ni[:, 1])


def bvh_walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Plain version of the whole-stream walk.  ``rays`` are six (N,) float32
    columns; ``t_init < 0`` marks a dead lane.  Returns (t_best, slot): slot
    -1 where nothing hit; a shadow hit sets t_best to -1."""
    return _walk_reference(s, rays, t_lo, t_init, shadow, treelets=False)


def treelet_walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Plain version of the treelet walk; same contract as
    :func:`bvh_walk_reference`."""
    return _walk_reference(s, rays, t_lo, t_init, shadow, treelets=True)


# ---------------------------------------------------------------------------
# Walks: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def _check(s: BVHStreams, rays, t_lo, t_init):
    n = t_init.shape[0]
    for c in (*rays, t_lo, t_init):
        if c.dtype != _F32 or tuple(c.shape) != (n,) or not c.is_contiguous():
            raise ValueError(f"ray columns must be contiguous ({n},) float32, got "
                             f"{tuple(c.shape)} {c.dtype}")
    for name in ("nodes_f", "leaves", "tl_box"):
        x = getattr(s, name)
        if x.dtype != _F32 or not x.is_contiguous():
            raise ValueError(f"streams.{name} must be contiguous float32")
    for name in ("nodes_i", "tl_lim"):
        x = getattr(s, name)
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"streams.{name} must be contiguous int32")
    if n >= 2**31:
        raise ValueError("BVH walks take fewer than 2**31 rays")


def _walk(kind: str, s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    dev = t_init.device
    n = t_init.shape[0]
    t_out = torch.empty(n, dtype=_F32, device=dev)
    slot_out = torch.empty(n, dtype=torch.int32, device=dev)
    head = (int(shadow), s.nodes_f, s.nodes_i, s.leaves, s.num_nodes, s.n_leaves, s.leaf_size)
    if kind == "treelet":
        head += (s.tl_box, s.tl_lim, s.n_treelets)
    _ext.launch(f"{kind}_walk_launch", dev, *head, *rays, t_lo, t_init, t_out, slot_out, n)
    LAUNCHES[f"{kind}_{'shadow' if shadow else 'closest'}"] += 1
    return t_out, slot_out


def bvh_walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Whole-stream walk (K4's contract); see :func:`bvh_walk_reference`."""
    if not _on_cuda((s.nodes_f, *rays, t_lo, t_init)):
        return bvh_walk_reference(s, rays, t_lo, t_init, shadow)
    _check(s, rays, t_lo, t_init)
    return _walk("bvh", s, rays, t_lo, t_init, shadow)


def treelet_walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Treelet walk (K5's contract); see :func:`treelet_walk_reference`."""
    if not _on_cuda((s.nodes_f, *rays, t_lo, t_init)):
        return treelet_walk_reference(s, rays, t_lo, t_init, shadow)
    _check(s, rays, t_lo, t_init)
    return _walk("treelet", s, rays, t_lo, t_init, shadow)


def walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """The JAX dispatch (pallas_bvh.py:1643-1650): the treelet walk for
    multi-treelet streams, the whole-stream walk otherwise."""
    fn = treelet_walk if s.n_treelets > 1 else bvh_walk
    return fn(s, rays, t_lo, t_init, shadow)


# ---------------------------------------------------------------------------
# Public entry points (the JAX wrappers' signatures)
# ---------------------------------------------------------------------------


def slot_to_tri(s: BVHStreams, rays, slot):
    """Scene triangle of each lane's leaf slot in the lane's own octant
    stream (``_slot_to_tri`` :1343).  Returns (tri, found)."""
    flat = octant(rays) * s.tri_id.shape[1] + torch.clamp_min(slot, 0).long()
    tri = s.tri_id.reshape(-1)[flat]
    found = (slot >= 0) & (tri >= 0)
    return torch.where(found, tri, -1), found


def bvh_closest(tables, o, d, *, t_min, t_max, active):
    """Closest hit over the scene's BVH streams: (t, tri, u, v) with t = inf
    and tri = -1 on a miss (``packet_closest`` :1604).  ``t_min`` may be a
    scalar or per lane."""
    s = tables.pbvh
    n = o.x.shape[0]
    dev = o.x.device
    rays = ray_columns(o, d)
    t_lo = _lanes(t_min, n, dev).contiguous()
    t_init = torch.where(active, _lanes(t_max, n, dev), -1.0).contiguous()
    t_best, slot = walk(s, rays, t_lo, t_init, shadow=False)
    tri, found = slot_to_tri(s, rays, slot)
    u, v = winner_uv(tables, o, d, tri)
    return (
        torch.where(found, t_best, torch.inf),
        tri,
        torch.where(found, u, 0.0),
        torch.where(found, v, 0.0),
    )


def bvh_shadow(tables, o, d, *, t_max, active):
    """First-hit occlusion over the BVH streams with tMin = 0; inactive lanes
    are never occluded (``packet_shadow`` :1677)."""
    s = tables.pbvh
    n = o.x.shape[0]
    dev = o.x.device
    rays = ray_columns(o, d)
    t_lo = torch.zeros(n, dtype=_F32, device=dev)
    t_init = torch.where(active, _lanes(t_max, n, dev), -1.0).contiguous()
    _, slot = walk(s, rays, t_lo, t_init, shadow=True)
    return (slot >= 0) & active
