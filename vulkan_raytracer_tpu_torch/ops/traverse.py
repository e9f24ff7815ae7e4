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
* a leaf runs one Möller-Trumbore test per real triangle (its padding
  slots, degenerate and never hit, are skipped) with the arithmetic of
  :614-636 (``dense.mt``); a hit is ``t_lo < t <= t_best``; the closest walk
  replaces when ``t < t_best`` or nothing hit yet (the first triangle
  visited wins a tie, :644); the shadow walk ends at its first hit with
  t_best = -1 (:637-646);
* the treelet walk first slab-tests the ray against every treelet box
  (the glue's exact per-ray test, :1120-1140: enters when ``near <= far``,
  ``far >= t_lo`` and ``near <= t_init``, at ``entry = max(near, 0)``; the
  kernel skips the boxes of a group whose union box the ray misses, which
  rounding cannot change), then walks the entered treelets in ascending
  (entry, treelet id), each one's range ``tl_lim[octant, k]`` of the
  stream, and stops when the next entry is > t_best (strictly: a hit at
  exactly the initial bound is still found).

So both walks find the closest hit over every triangle; they differ only at
exact-t ties.  Dispatch is the JAX rule: the treelet walk when the streams
have more than one treelet (``_windowed_enabled`` :1178), else the
whole-stream walk.

The stream builder is ``_build_streams`` (:144) and ``_cut_tables`` (:214)
with an explicit ``max_tris`` (2048, the JAX default off the TPU; the TPU's
upload-time probe ``_probe_treelet_cut`` :291 is not ported).  The content is
the same; the layout is the card's (:class:`BVHStreams`): 32-byte node
records and one table of 48-byte triangle rows shared by the eight octant
streams, where the TPU kept one contiguous DMA stream of triangles per
octant.  :func:`walk_visits` counts a walk's work for the kernels' bounds.

The emissive-pdf probe over an emissive-only BVH, for scenes with more than
``dense.EMISSIVE_MAX_TRIS`` emissive triangles, is here too:
:func:`bvh_emissive_pdf`, the counterpart of ``trace_emissive_pdf``
(``vulkan_raytracer_tpu/ops/traverse.py:241``, an XLA ``while_loop``, not a
Pallas kernel).  On the card it is a CUDA walk over wide nodes collapsed
from the same binary tree (``emissive_walk_kernel``: eight lanes a ray, the
top of the tree in shared memory), with :func:`emissive_pdf_walk_reference`,
a lockstep walk of the binary tree, as its plain version, over an
:class:`EmissiveStream`; the two are bit-equal.  Its contract is the JAX
function's, which is not the dense pdf kernel's: the box test of
``ops/intersect.py`` (``safe_inv_dir`` with 1e-20, no conservative scale),
the ray extent (t_min, 1e32], the normal divided by max(|n|, 1e-20), the raw
area, and the sum in the tree's visit order, one leaf at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _ext, trace
from .dense import _on_cuda, mt, ray_columns
from .math3 import safe_inv_dir

#: default target triangle slots per treelet (pallas_bvh.py:141)
TREELET_TRIS = 2048
#: cap on treelets per stream (pallas_bvh.py:135); the CUDA treelet walk
#: keeps the entered treelets as a 128-bit mask
MAX_TREELETS = 128
#: treelets under one group box (consecutive ids; the CUDA treelet walk tests
#: a group's treelets only when the ray enters the group's box)
TREELET_GROUP = 8
#: 1 + 2 gamma_3 in float32 (1 + 3 * 2^-23): the conservative scale of a slab
#: test's far end and t bound (Ize 2013)
ROBUST = 1.0 + 3.0 * 2.0**-23
_TINY = 1e-30

#: Kernel launches since the last reset, by kernel and variant.
LAUNCHES = {"bvh_closest": 0, "bvh_shadow": 0, "treelet_closest": 0, "treelet_shadow": 0,
            "emissive_pdf": 0}

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
    d[k] < 0) over one shared triangle table, in the layout the CUDA walks
    read with 16-byte loads.  The content is the JAX ``PacketBVH``'s
    (pallas_bvh.py:96-122) with each leaf's triangles kept once instead of
    once per octant, and without its padding slots.

    Node ``i`` of octant ``o`` is the 32-byte record ``nodes[o, i]``:
    ``bmin.xyz, leaf | bmax.xyz, link``, where ``leaf`` and ``link`` are
    int32 bit patterns.  ``leaf`` is -1 for an interior node, whose ``link``
    is its stream-local skip pointer; a leaf's ``leaf`` is the row of its
    first triangle in ``tris`` and its ``link`` the count of its triangles
    (a leaf's skip pointer is always ``i + 1``).  ``tris[r]`` is one
    48-byte row ``v0.xyz 0, e1.xyz 0, e2.xyz 0``: the real slots of the
    BVH's leaves, in slot order, so a leaf's triangles are contiguous and in
    their order in the leaf.  ``tri_id[r]`` is row r's scene triangle.
    ``tl_group`` holds the union box of each run of ``TREELET_GROUP``
    consecutive treelets: a ray that misses it misses each of their boxes.
    ``cut_tris`` is the slot budget the treelet cut was made with, so a
    refitted tree (same topology) is cut into the same treelets."""

    nodes: torch.Tensor  # (8, Nn, 8) f32: bmin.xyz, leaf | bmax.xyz, link
    tris: torch.Tensor  # (Nt, 12) f32: v0.xyz 0, e1.xyz 0, e2.xyz 0
    tri_id: torch.Tensor  # (Nt,) i32
    tl_box: torch.Tensor  # (K, 6) f32 treelet boxes, slightly dilated
    tl_group: torch.Tensor  # (ceil(K / TREELET_GROUP), 6) f32 union boxes
    tl_lim: torch.Tensor  # (8, K, 2) i32 per-octant stream range [start, end)
    num_nodes: int
    n_treelets: int
    cut_tris: int = TREELET_TRIS

    @property
    def nbytes(self) -> int:
        """Bytes the streams take on their device."""
        return sum(t.nbytes for t in self._tensors().values())

    def _tensors(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.type == "torch.Tensor"}

    def to(self, device) -> "BVHStreams":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self._tensors().items()})


def build_streams(bvh, max_tris: int = TREELET_TRIS,
                  max_treelets: int = MAX_TREELETS) -> BVHStreams:
    """Repack a ThreadedBVH (the port's, or any record with the same fields)
    into eight per-octant node streams over one triangle table, and a
    treelet cut of at most ``max_treelets`` subtrees of about ``max_tris``
    triangle slots (``_build_streams`` :144 and ``_cut_tables`` :214).
    Host-side NumPy; returns CPU tensors."""
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
    is_leaf = first >= 0

    # the triangle table: the real slots in slot order (padding has id -1)
    real = tri_id >= 0
    rows = np.concatenate([[0], np.cumsum(real)])  # slot -> its row in the table
    tris = np.zeros((int(rows[-1]), 12), np.float32)
    for c, col in enumerate((bvh.tri_v0, bvh.tri_e1, bvh.tri_e2)):
        tris[:, 4 * c:4 * c + 3] = host(col)[real]
    slot0 = np.where(is_leaf, first, 0)  # a leaf owns slots [first, first + k)
    leaf_row = np.where(is_leaf, rows[slot0], -1)
    leaf_count = rows[slot0 + k] - rows[slot0]

    perms = octant_permutations(amin, amax, first, miss)
    pos8 = np.empty((8, n), np.int64)  # old node index -> stream position
    nodes = np.zeros((8, n, 8), np.float32)
    words = nodes.view(np.int32)
    for o in range(8):
        old = perms[o]  # new node index -> old node index
        pos8[o, old] = np.arange(n)
        nodes[o, :, 0:3] = amin[old]
        nodes[o, :, 4:7] = amax[old]
        words[o, :, 3] = leaf_row[old]
        words[o, :, 7] = np.where(is_leaf[old], leaf_count[old], np.arange(n) + size[old])

    max_tris = max(int(max_tris), k)
    cut = treelet_cut(first, miss, k, max_tris)
    while cut.shape[0] > max_treelets:
        max_tris *= 2
        cut = treelet_cut(first, miss, k, max_tris)
    ext = amax[cut] - amin[cut]
    eps = 1e-5 * np.maximum(ext.max(axis=1, keepdims=True), 1e-3) + 1e-7
    tl_box = np.concatenate([amin[cut] - eps, amax[cut] + eps], axis=1).astype(np.float32)
    tl_lim = np.stack([pos8[:, cut], pos8[:, cut] + size[cut]], axis=-1).astype(np.int32)
    groups = np.arange(0, tl_box.shape[0], TREELET_GROUP)
    tl_group = np.concatenate([np.minimum.reduceat(tl_box[:, :3], groups),
                               np.maximum.reduceat(tl_box[:, 3:], groups)], axis=1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a))

    return BVHStreams(
        nodes=t(nodes), tris=t(tris), tri_id=t(tri_id[real].astype(np.int32)),
        tl_box=t(tl_box), tl_group=t(tl_group), tl_lim=t(tl_lim),
        num_nodes=n, n_treelets=int(cut.shape[0]), cut_tris=max_tris,
    )


#: children of a wide node of the emissive walk (csrc/bvh_walk.cu kWide)
EMISSIVE_WIDE = 8
#: stack words the CUDA walk holds per ray (csrc/bvh_walk.cu kStack): it
#: takes a tree whose walk can stack at most this many (EmissiveStream.stack)
EMISSIVE_STACK = 64
#: a leaf's stack word in the CUDA walk holds its first row in the bits below
#: this (csrc/bvh_walk.cu kRowBits), so a stream holds fewer rows than 2**it
EMISSIVE_ROW_BITS = 28
#: wide nodes the CUDA walk takes (csrc/bvh_walk.cu kMaxWideNodes)
EMISSIVE_MAX_NODES = 2**24


@dataclasses.dataclass(frozen=True)
class EmissiveStream:
    """The emissive-only threaded BVH with everything the pdf probe reads, in
    the layouts the walks load 16 bytes at a time.

    Node ``i`` (the BVH's own preorder; the probe adds up every hit, so there
    is no front-to-back order to keep per octant) is the 32-byte record
    ``nodes[i]`` of :class:`BVHStreams`: ``bmin.xyz, leaf | bmax.xyz, link``;
    the plain walk reads these.  ``rows[r]`` is one 80-byte row per real leaf
    slot, in slot order: ``v0.xyz, e1.xyz, e2.xyz, p_delta, area, n0.xyz,
    n1.xyz, n2.xyz`` (the columns of the dense pdf table, with the area as
    uploaded).

    ``wide[w]`` is the same tree with its interior nodes collapsed into
    nodes of up to :data:`EMISSIVE_WIDE` children, which the CUDA walk reads
    (:func:`wide_layout`): child ``j`` is the 32-byte record
    ``wide[w, 8j:8j+8]`` = ``bmin.xyz, ref | bmax.xyz, kind`` with the
    binary node's own box; ``kind`` is -1 for an interior child (``ref`` its
    wide node), the count of real slots for a leaf (``ref`` its first row),
    0 for an empty child.  Children are in the binary preorder and wide
    nodes breadth first, so the top of the tree is a prefix of ``wide``.
    ``stack`` is the most words the CUDA walk's stack can hold."""

    nodes: torch.Tensor  # (Nn, 8) f32: bmin.xyz, leaf | bmax.xyz, link
    rows: torch.Tensor  # (Nr, 20) f32
    wide: torch.Tensor  # (Nw, 8 * EMISSIVE_WIDE) f32: per child bmin.xyz, ref | bmax.xyz, kind
    num_nodes: int
    stack: int

    @property
    def nbytes(self) -> int:
        return self.nodes.nbytes + self.rows.nbytes + self.wide.nbytes

    def to(self, device) -> "EmissiveStream":
        return dataclasses.replace(self, nodes=self.nodes.to(device), rows=self.rows.to(device),
                                   wide=self.wide.to(device))


def wide_layout(first, miss, row0, count) -> tuple:
    """The wide nodes of a threaded binary tree (``first``: a leaf's first
    slot or -1, ``miss``: the skip pointers; ``row0`` / ``count``: each
    leaf's first row and real slots).

    A wide node is a binary interior node opened down to a frontier of at
    most :data:`EMISSIVE_WIDE` children, leaves or interior nodes that root
    wide nodes of their own.  The frontiers are chosen by a dynamic program
    over the tree, bottom up, for the fewest wide nodes in all (so the
    bottom nodes are full, where cutting every third level from the top
    leaves them with two children); among equal counts it opens a node to
    more children, and splits a frontier as early as it can.  It reads the
    topology alone, so a refitted tree has the layout of its parent.  A tree
    that is one leaf has a root with that leaf as its one child.  Returns
    (the (Nw, W) binary node of each child, -1 where empty; the (Nw, W)
    ``ref`` words; the (Nw, W) ``kind`` words; the most words the CUDA
    walk's stack can hold, every child entered: it pushes a node's entered
    children, the first on top, and pops them in preorder)."""
    w = EMISSIVE_WIDE
    n = first.shape[0]
    is_leaf = first >= 0
    if count.max() > w:  # the walk tests a leaf's slots in one batch of w
        raise ValueError(f"the emissive walk takes leaves of at most {w} slots")
    nodes = np.arange(n)
    left = np.where(is_leaf, -1, nodes + 1)
    right = np.where(is_leaf, -1, miss[np.minimum(nodes + 1, n - 1)])
    height = np.zeros(n, np.int64)
    for x in np.flatnonzero(~is_leaf)[::-1].tolist():  # children come after their parent
        height[x] = 1 + max(height[x + 1], height[right[x]])
    # cost[x, k]: the fewest wide nodes below x when x gives its parent's
    # frontier k children (k = 1: x itself, which roots its own wide node
    # unless it is a leaf); split[x, k]: how many of them its left child gives
    huge = np.int64(1) << 40
    cost = np.full((n, w + 1), huge, np.int64)
    cost[is_leaf, 1] = 0
    split = np.zeros((n, w + 1), np.int64)
    opened = np.zeros(n, np.int64)  # a wide root's own frontier size
    for h in range(1, int(height.max()) + 1):
        xs = np.flatnonzero(height == h)
        lc, rc = cost[left[xs]], cost[right[xs]]
        for k in range(2, w + 1):
            kl = np.arange(1, k)
            total = lc[:, kl] + rc[:, k - kl]
            best = total.argmin(1)  # the first of equals: the earliest split
            cost[xs, k] = total[np.arange(xs.shape[0]), best]
            split[xs, k] = kl[best]
        ks = w - cost[xs, w:1:-1].argmin(1)  # the most children among equals
        opened[xs] = ks
        cost[xs, 1] = 1 + cost[xs, ks]

    def frontier(x, k):
        out, todo = [], [(x, k)]
        while todo:
            y, m = todo.pop()
            if m == 1:
                out.append(y)
            else:
                todo += [(right[y], m - split[y, m]), (left[y], split[y, m])]
        return out

    queue = [[0]] if is_leaf[0] else [frontier(0, opened[0])]
    below = [0]  # stack words under each queued node's children, all entered
    kids_of = np.full((n + 1, w), -1, np.int64)
    ref = np.zeros((n + 1, w), np.int32)
    kind = np.zeros((n + 1, w), np.int32)
    head = 0
    while head < len(queue):
        for j, y in enumerate(queue[head]):
            kids_of[head, j] = y
            if is_leaf[y]:
                ref[head, j], kind[head, j] = row0[y], count[y]
            else:
                ref[head, j], kind[head, j] = len(queue), -1
                queue.append(frontier(y, opened[y]))
                below.append(below[head] + len(queue[head]) - 1 - j)
        head += 1
    stack = max(b + len(k) for b, k in zip(below, queue))
    return kids_of[:head], ref[:head], kind[:head], stack


def build_emissive_stream(ebvh, em_tables) -> EmissiveStream:
    """Pack the emissive-only ThreadedBVH ``ebvh`` and the per-emissive-
    triangle ``em_tables`` (p_delta, area, n0, n1, n2, indexed by the BVH's
    ``tri_id``) into an :class:`EmissiveStream`.  Host-side NumPy; returns
    CPU tensors."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    k = ebvh.leaf_size
    first, miss, tri_id = host(ebvh.first_tri), host(ebvh.miss), host(ebvh.tri_id)
    n = first.shape[0]
    is_leaf = first >= 0
    real = tri_id >= 0
    ids = tri_id[real]
    before = np.concatenate([[0], np.cumsum(real)])  # slot -> its row
    rows = np.empty((ids.shape[0], 20), np.float32)
    for c, col in enumerate((ebvh.tri_v0, ebvh.tri_e1, ebvh.tri_e2)):
        rows[:, 3 * c:3 * c + 3] = host(col)[real]
    rows[:, 9] = host(em_tables.p_delta)[ids]
    rows[:, 10] = host(em_tables.area)[ids]
    for c, col in enumerate((em_tables.n0, em_tables.n1, em_tables.n2)):
        rows[:, 11 + 3 * c:14 + 3 * c] = host(col)[ids]
    slot0 = np.where(is_leaf, first, 0)
    row0 = np.where(is_leaf, before[slot0], -1)
    count = np.where(is_leaf, before[slot0 + k] - before[slot0], 0)
    box_min, box_max = host(ebvh.aabb_min), host(ebvh.aabb_max)
    nodes = np.zeros((n, 8), np.float32)
    words = nodes.view(np.int32)
    nodes[:, 0:3] = box_min
    nodes[:, 4:7] = box_max
    words[:, 3] = row0
    words[:, 7] = np.where(is_leaf, count, miss)
    kids, ref, kind, stack = wide_layout(first, miss, row0, count)
    wide = np.zeros((kids.shape[0], EMISSIVE_WIDE, 8), np.float32)
    some = kids >= 0
    wide[some, 0:3] = box_min[kids[some]]
    wide[some, 4:7] = box_max[kids[some]]
    wide.view(np.int32)[..., 3] = ref
    wide.view(np.int32)[..., 7] = kind
    return EmissiveStream(nodes=torch.as_tensor(nodes), rows=torch.as_tensor(rows),
                          wide=torch.as_tensor(wide.reshape(kids.shape[0], -1)), num_nodes=n,
                          stack=stack)


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


def box_entries(box, rays, t_lo, t_init):
    """The glue's per-ray box test (pallas_bvh.py:1120-1140) against each
    row of ``box`` (B, 6): (N, B) ``enters`` and ``entry`` = max(near, 0),
    written so that a zero entry is +0.0 (a radix sort puts -0.0 first)."""
    o = rays[:3]
    inv = [inv_dir(c) for c in rays[3:]]
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
#: v0.xyz, e1.xyz, e2.xyz in a row of ``BVHStreams.tris``
_TRI_COLS = (0, 1, 2, 4, 5, 6, 8, 9, 10)
#: rays per block of the (N, K) treelet-order computation
_ORDER_BLOCK = 1 << 15


def _walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool, treelets: bool,
                    visits: dict | None = None):
    n = t_init.shape[0]
    dev = t_init.device
    t_out = t_init.clone()
    slot_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lanes = torch.nonzero(t_init >= 0).squeeze(1)
    if lanes.numel() == 0:
        return t_out, slot_out
    nodes = s.nodes.reshape(-1, 8)
    links = nodes.view(torch.int32)[:, 3::4].long()  # leaf row | -1, link

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
        group_size = torch.clamp(s.n_treelets - torch.arange(
            0, s.n_treelets, TREELET_GROUP, device=dev), max=TREELET_GROUP)
        for b in range(0, lanes.numel(), _ORDER_BLOCK):
            blk = lanes[b:b + _ORDER_BLOCK]
            blk_rays = [c[blk] for c in rays]
            enters, ent = box_entries(s.tl_box, blk_rays, t_lo[blk], t_init[blk])
            ent, order[blk] = torch.sort(torch.where(enters, ent, torch.inf), dim=1,
                                         stable=True)
            entry[blk] = ent
            n_entered[blk] = enters.sum(1)
            if visits is not None:  # the kernel tests a group's treelets only inside it
                g_in, _ = box_entries(s.tl_group, blk_rays, t_lo[blk], t_init[blk])
                visits["boxes"][blk] = group_size.numel() + (g_in * group_size).sum(1)
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
        box = nodes[node]
        o, inv = fs[:, _OX:_OX + 3], fs[:, _IV:_IV + 3]
        lo = (box[:, 0:3] - o) * inv
        hi = (box[:, 4:7] - o) * inv
        near3, far3 = torch.minimum(lo, hi), torch.maximum(lo, hi)
        near = torch.maximum(torch.maximum(near3[:, 0], near3[:, 1]),
                             torch.clamp_min(near3[:, 2], 0.0))
        far = torch.minimum(torch.minimum(far3[:, 0], far3[:, 1]), far3[:, 2])
        t_best = fs[:, _TB]
        hit = (near <= far * ROBUST) & (near <= t_best * ROBUST)
        ln = links[node]
        is_leaf = ln[:, 0] >= 0
        leaf = hit & is_leaf
        if visits is not None:
            visits["nodes"][ints[:, _LANE]] += 1
            visits["node_rows"][node] = True

        if bool(leaf.any()):
            li = leaf.nonzero().squeeze(1)
            row0, count = ln[li, 0], ln[li, 1]  # the leaf's triangles, padding skipped
            j = torch.arange(max(int(count.max()), 1), device=dev)
            real = j < count[:, None]
            rows = torch.where(real, row0[:, None] + j, row0[:, None])
            tri = s.tris[rows]  # (L, m, 12)
            ray = [fs[li, c, None] for c in range(6)]
            inside, _, _, tt = mt([tri[..., c] for c in _TRI_COLS], ray)
            tb = fs[li, _TB]
            h = real & inside & (tt > fs[li, _LO, None]) & (tt <= tb[:, None])
            any_h = h.any(1)
            slot = ints[li, _SLOT]
            if visits is not None:
                visits["leaves"][ints[li, _LANE]] += 1
                visits["tris"][ints[li, _LANE]] += count
                visits["tri_rows"][rows[real]] = True
            if shadow:  # the first hit occludes and ends the walk
                first = h.int().argmax(1)
                fs[li, _TB] = torch.where(any_h, -1.0, tb)
                ints[li, _SLOT] = torch.where(any_h, row0 + first, slot)
                ints[li, _END] = torch.where(any_h, -1, ints[li, _END])
                if treelets:
                    ints[li, _RND] = torch.where(any_h, s.n_treelets, ints[li, _RND])
            else:  # the least t; among equal t the first triangle (the kernel's order)
                t_min = torch.where(h, tt, torch.inf).amin(1)
                first = torch.where(h & (tt == t_min[:, None]), j, j.numel()).amin(1)
                rep = any_h & ((t_min < tb) | (slot < 0))
                fs[li, _TB] = torch.where(rep, t_min, tb)
                ints[li, _SLOT] = torch.where(rep, row0 + first, slot)

        # entered -> the next node; missed -> the skip pointer (a leaf's is cur + 1)
        ints[:, _CUR] = torch.where(hit | is_leaf, cur + 1, ln[:, 1])


def bvh_walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Plain version of the whole-stream walk.  ``rays`` are six (N,) float32
    columns; ``t_init < 0`` marks a dead lane.  Returns (t_best, slot): slot
    -1 where nothing hit; a shadow hit sets t_best to -1."""
    return _walk_reference(s, rays, t_lo, t_init, shadow, treelets=False)


def treelet_walk_reference(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Plain version of the treelet walk; same contract as
    :func:`bvh_walk_reference`."""
    return _walk_reference(s, rays, t_lo, t_init, shadow, treelets=True)


def walk_visits(s: BVHStreams, rays, t_lo, t_init, shadow: bool, treelets: bool) -> dict:
    """The work of one walk, counted on the lockstep plain walk (the same
    visits as the kernels make).  Per ray, int64 (N,): ``nodes`` (slab
    tests), ``leaves`` (leaves entered), ``tris`` (triangle tests, padding
    skipped) and ``boxes`` (the treelet walk's pass over its boxes: one test
    per group box, and one per treelet of each group the ray enters; 0 for
    the whole-stream walk; the CUDA walk's later passes, which refill its
    short list of next treelets, are not counted).  ``node_rows`` and
    ``tri_rows`` count the distinct node records and triangle rows the walk
    read."""
    n = t_init.shape[0]
    dev = t_init.device
    v = {k: torch.zeros(n, dtype=torch.int64, device=dev)
         for k in ("nodes", "leaves", "tris", "boxes")}
    v["node_rows"] = torch.zeros(8 * s.num_nodes, dtype=torch.bool, device=dev)
    v["tri_rows"] = torch.zeros(s.tris.shape[0], dtype=torch.bool, device=dev)
    _walk_reference(s, rays, t_lo, t_init, shadow, treelets, visits=v)
    v["node_rows"] = int(v["node_rows"].sum())
    v["tri_rows"] = int(v["tri_rows"].sum())
    return v


#: the far end of the probe's ray extent (raygen.rgen:70, lightsample.glsl:136)
_PDF_T_MAX = 1e32


def emissive_pdf_walk_reference(s: EmissiveStream, rays, active, t_min: float,
                                visits: dict | None = None):
    """Plain version of the emissive-pdf walk: every active lane walks the
    threaded tree in lockstep (one node per turn, the lanes still walking
    kept compact) and adds, leaf by leaf in visit order and slot by slot
    within a leaf, ``p_delta * t^2 / max(area * |n.d|, 1e-30)`` for every
    triangle hit with t_min < t <= 1e32; n is the interpolated vertex normal
    over max(|n|, 1e-20).  ``rays`` are six (N,) float32 columns, ``active``
    (N,) bool.  Returns the pdf, 0 on inactive lanes.  ``visits``: see
    :func:`emissive_walk_visits`; with a list under ``"order"`` each turn
    appends (the lanes that entered a leaf, the leaf nodes)."""
    n = active.shape[0]
    dev = active.device
    pdf_out = torch.zeros(n, dtype=_F32, device=dev)
    lanes = torch.nonzero(active).squeeze(1)
    if lanes.numel() == 0:
        return pdf_out
    links = s.nodes.view(torch.int32)[:, 3::4].long()  # leaf row | -1, count | skip
    cols = [c[lanes] for c in rays]
    o = torch.stack(cols[:3], 1)
    inv = torch.stack([safe_inv_dir(c) for c in cols[3:]], 1)
    cur = torch.zeros_like(lanes)
    pdf = torch.zeros(lanes.numel(), dtype=_F32, device=dev)
    while True:
        done = cur >= s.num_nodes
        if bool(done.any()):
            pdf_out[lanes[done]] = pdf[done]
            keep = ~done
            lanes, cur, pdf, o, inv = lanes[keep], cur[keep], pdf[keep], o[keep], inv[keep]
            cols = [c[keep] for c in cols]
        if lanes.numel() == 0:
            return pdf_out
        box = s.nodes[cur]
        lo = (box[:, 0:3] - o) * inv
        hi = (box[:, 4:7] - o) * inv
        near = torch.minimum(lo, hi).amax(1)
        far = torch.maximum(lo, hi).amin(1)
        enter = (near <= far) & (far >= t_min) & (near <= _PDF_T_MAX)
        ln = links[cur]
        is_leaf = ln[:, 0] >= 0
        leaf = enter & is_leaf
        if visits is not None:
            visits["nodes"][lanes] += 1
            visits["node_rows"][cur] = True
        if bool(leaf.any()):
            li = leaf.nonzero().squeeze(1)
            row0, count = ln[li, 0], ln[li, 1]
            leaf_sum, idx, real, hit = emissive_leaf_sums(s, [c[li] for c in cols], row0, count,
                                                          t_min)
            pdf[li] = pdf[li] + leaf_sum
            if visits is not None:
                if "order" in visits:  # (lanes, leaf nodes) entered this turn
                    visits["order"].append((lanes[li], cur[li]))
                visits["tris"][lanes[li]] += count
                visits["hits"][lanes[li]] += hit.sum(1)
                visits["tri_rows"][idx[real]] = True
        cur = torch.where(enter | is_leaf, cur + 1, ln[:, 1])


def emissive_leaf_sums(s: EmissiveStream, cols, row0, count, t_min: float):
    """Each of L lanes' sum over one leaf (rays ``cols``: six (L,) columns;
    the leaf's first row and real slots ``row0``, ``count``): ``p_delta *
    t^2 / max(area * |n.d|, 1e-30)`` of every slot hit with t_min < t <=
    1e32, 0 for the others, added in slot order.  Returns (the sums, the
    (L, m) rows, which of them are real, which were hit)."""
    j = torch.arange(max(int(count.max()), 1), device=row0.device)
    real = j < count[:, None]
    idx = torch.where(real, row0[:, None] + j, row0[:, None])
    tri = s.rows[idx]  # (L, m, 20)
    dx, dy, dz = (cols[c][:, None] for c in (3, 4, 5))
    inside, u, v, t = mt([tri[..., c] for c in range(9)],
                         [cols[c][:, None] for c in range(3)] + [dx, dy, dz])
    hit = real & inside & (t > t_min) & (t <= _PDF_T_MAX)
    w0 = 1.0 - u - v
    nx = w0 * tri[..., 11] + u * tri[..., 14] + v * tri[..., 17]
    ny = w0 * tri[..., 12] + u * tri[..., 15] + v * tri[..., 18]
    nz = w0 * tri[..., 13] + u * tri[..., 16] + v * tri[..., 19]
    length = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
    cosine = torch.abs(nx / length * dx + ny / length * dy + nz / length * dz)
    term = tri[..., 9] * t * t / torch.clamp_min(tri[..., 10] * cosine, 1e-30)
    term = torch.where(hit, term, 0.0)
    leaf_sum = term[:, 0]
    for q in range(1, term.shape[1]):  # slot order, as the kernel adds them
        leaf_sum = leaf_sum + term[:, q]
    return leaf_sum, idx, real, hit


def emissive_walk_visits(s: EmissiveStream, rays, active, t_min: float) -> dict:
    """The work of one emissive-pdf walk, counted on the plain walk (the
    kernel makes the same visits).  Per ray, int64 (N,): ``nodes`` (box
    tests), ``tris`` (triangle tests, padding skipped) and ``hits`` (terms
    added); ``node_rows`` and ``tri_rows`` count the distinct records read."""
    n = active.shape[0]
    dev = active.device
    v = {k: torch.zeros(n, dtype=torch.int64, device=dev) for k in ("nodes", "tris", "hits")}
    v["node_rows"] = torch.zeros(s.num_nodes, dtype=torch.bool, device=dev)
    v["tri_rows"] = torch.zeros(s.rows.shape[0], dtype=torch.bool, device=dev)
    emissive_pdf_walk_reference(s, rays, active, t_min, visits=v)
    v["node_rows"] = int(v["node_rows"].sum())
    v["tri_rows"] = int(v["tri_rows"].sum())
    return v


# ---------------------------------------------------------------------------
# Walks: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def _check(s: BVHStreams, rays, t_lo, t_init):
    n = t_init.shape[0]
    for c in (*rays, t_lo, t_init):
        if c.dtype != _F32 or tuple(c.shape) != (n,) or not c.is_contiguous():
            raise ValueError(f"ray columns must be contiguous ({n},) float32, got "
                             f"{tuple(c.shape)} {c.dtype}")
    for name in ("nodes", "tris", "tl_box", "tl_group"):
        x = getattr(s, name)
        if x.dtype != _F32 or not x.is_contiguous():
            raise ValueError(f"streams.{name} must be contiguous float32")
    for name in ("nodes", "tris"):  # the kernels read them as float4
        if getattr(s, name).data_ptr() % 16:
            raise ValueError(f"streams.{name} must be 16-byte aligned")
    if s.tl_lim.dtype != torch.int32 or not s.tl_lim.is_contiguous():
        raise ValueError("streams.tl_lim must be contiguous int32")
    if n >= 2**31:
        raise ValueError("BVH walks take fewer than 2**31 rays")


def _walk(kind: str, s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    dev = t_init.device
    n = t_init.shape[0]
    t_out = torch.empty(n, dtype=_F32, device=dev)
    slot_out = torch.empty(n, dtype=torch.int32, device=dev)
    head = (int(shadow), s.nodes, s.tris, s.num_nodes)
    if kind == "treelet":
        head += (s.tl_box, s.tl_group, s.tl_lim, s.n_treelets)
    _ext.launch(f"{kind}_walk_launch", dev, *head, *rays, t_lo, t_init, t_out, slot_out, n)
    LAUNCHES[f"{kind}_{'shadow' if shadow else 'closest'}"] += 1
    return t_out, slot_out


def bvh_walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Whole-stream walk (K4's contract); see :func:`bvh_walk_reference`."""
    if not _on_cuda((s.nodes, *rays, t_lo, t_init)):
        return bvh_walk_reference(s, rays, t_lo, t_init, shadow)
    _check(s, rays, t_lo, t_init)
    return _walk("bvh", s, rays, t_lo, t_init, shadow)


def treelet_walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """Treelet walk (K5's contract); see :func:`treelet_walk_reference`."""
    if not _on_cuda((s.nodes, *rays, t_lo, t_init)):
        return treelet_walk_reference(s, rays, t_lo, t_init, shadow)
    _check(s, rays, t_lo, t_init)
    return _walk("treelet", s, rays, t_lo, t_init, shadow)


def walk(s: BVHStreams, rays, t_lo, t_init, shadow: bool):
    """The JAX dispatch (pallas_bvh.py:1643-1650): the treelet walk for
    multi-treelet streams, the whole-stream walk otherwise."""
    fn = treelet_walk if s.n_treelets > 1 else bvh_walk
    return fn(s, rays, t_lo, t_init, shadow)


def emissive_pdf_walk(s: EmissiveStream, rays, active, t_min: float):
    """The emissive-pdf walk (``trace_emissive_pdf``'s contract); see
    :func:`emissive_pdf_walk_reference`.  Launches ``emissive_walk_kernel``
    on CUDA tensors: it walks the wide nodes (``s.wide``) and is bit-equal to
    the plain version on active lanes, +0 on the others."""
    if not _on_cuda((s.wide, s.rows, *rays, active)):
        return emissive_pdf_walk_reference(s, rays, active, t_min)
    n = active.shape[0]
    for c in rays:
        if c.dtype != _F32 or tuple(c.shape) != (n,) or not c.is_contiguous():
            raise ValueError(f"ray columns must be contiguous ({n},) float32, got "
                             f"{tuple(c.shape)} {c.dtype}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,) or not active.is_contiguous():
        raise ValueError(f"active must be a contiguous ({n},) bool tensor")
    for name, width in (("wide", 8 * EMISSIVE_WIDE), ("rows", 20)):  # read as float4
        x = getattr(s, name)
        if (x.dtype != _F32 or x.dim() != 2 or x.shape[1] != width or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"stream.{name} must be contiguous, 16-byte aligned "
                             f"(N, {width}) float32")
    if (s.stack > EMISSIVE_STACK or s.wide.shape[0] > EMISSIVE_MAX_NODES
            or s.rows.shape[0] >= 2**EMISSIVE_ROW_BITS):
        raise ValueError(f"the emissive walk takes a tree whose walk stacks at most "
                         f"{EMISSIVE_STACK} words, with at most {EMISSIVE_MAX_NODES} wide nodes "
                         f"and fewer than 2**{EMISSIVE_ROW_BITS} rows, not {s.stack}, "
                         f"{s.wide.shape[0]} and {s.rows.shape[0]}")
    if n >= 2**31:
        raise ValueError("BVH walks take fewer than 2**31 rays")
    out = torch.empty(n, dtype=_F32, device=active.device)
    _ext.launch("emissive_walk_launch", active.device, s.wide, s.rows, s.wide.shape[0], *rays,
                active, float(t_min), out, n)
    LAUNCHES["emissive_pdf"] += 1
    return out


# ---------------------------------------------------------------------------
# Public entry points (the JAX wrappers' signatures)
# ---------------------------------------------------------------------------


def bvh_closest(tables, o, d, *, t_min, t_max, active, raw: bool = False):
    """Closest hit over the scene's BVH streams: (t, tri, u, v) with t = inf
    and tri = -1 on a miss (``packet_closest`` :1604).  ``t_min`` may be a
    scalar or per lane.  With ``raw``, the walk's result unfinished, (rays,
    t, slot, "bvh"): an alpha pass's commit finishes it."""
    s = tables.pbvh
    n = o.x.shape[0]
    dev = o.x.device
    rays = ray_columns(o, d)
    t_lo = trace.lanes(t_min, n, dev).contiguous()
    t_init = torch.where(active, trace.lanes(t_max, n, dev), -1.0).contiguous()
    t_best, slot = walk(s, rays, t_lo, t_init, shadow=False)
    if raw:
        return rays, t_best, slot, "bvh"
    return trace.hit_finish(tables, rays, t_best, slot, "bvh")


def bvh_shadow(tables, o, d, *, t_max, active):
    """First-hit occlusion over the BVH streams with tMin = 0; inactive lanes
    are never occluded (``packet_shadow`` :1677)."""
    s = tables.pbvh
    n = o.x.shape[0]
    dev = o.x.device
    rays = ray_columns(o, d)
    t_lo = torch.zeros(n, dtype=_F32, device=dev)
    t_init = torch.where(active, trace.lanes(t_max, n, dev), -1.0).contiguous()
    _, slot = walk(s, rays, t_lo, t_init, shadow=True)
    return (slot >= 0) & active


def bvh_emissive_pdf(tables, o, d, *, t_min, active):
    """Sum of the NEE pdf over every emissive triangle along each ray, walked
    through the scene's emissive-only BVH (``trace_emissive_pdf``,
    vulkan_raytracer_tpu/ops/traverse.py:241; shaders/emissivepdf.rahit:57-67).
    Inactive lanes return 0."""
    return emissive_pdf_walk(tables.em_stream, ray_columns(o, d), active.contiguous(),
                             float(t_min))
