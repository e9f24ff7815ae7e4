"""Threaded (skip-pointer) BVH over world-space triangles, built on the host.

Port of :mod:`vulkan_raytracer_tpu.accel.bvh` without jax: the builder
(``build_bvh`` :74, median split on the longest centroid axis, native C++
when g++ is available), the treelet frontier (``treelet_cut`` :217) and the
eight near-child-first preorders (``octant_permutations`` :251) are the same
NumPy code, so they are bit-equal to the JAX package's.  The result is a
:class:`ThreadedBVH` of CPU tensors; ``.to(device)`` moves it.

Layout (accel/bvh.py:16-26 of the JAX package): nodes in DFS preorder; an
AABB hit on node ``i`` goes to ``i + 1``, a miss (or a processed leaf) to
``miss[i]``, the preorder index past the subtree, and ``num_nodes`` ends the
walk.  Each leaf owns ``leaf_size`` contiguous triangle slots, padded with
degenerate triangles whose ``tri_id`` is -1.

``refit_bvh`` (:151) keeps a tree's topology and slot order and recomputes
its leaf rows and boxes after the vertices moved; it is bit-equal to the JAX
package's too.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ThreadedBVH:
    """Flattened threaded BVH plus its leaf-reordered triangle soup.

    ``first_tri[i] >= 0`` marks a leaf and indexes the first of ``leaf_size``
    contiguous slots; interior nodes store -1.  ``miss[i]`` is the skip
    pointer.  ``tri_id`` maps slots back to scene triangle ids (-1 padding).
    """

    aabb_min: torch.Tensor  # (Nn, 3) f32
    aabb_max: torch.Tensor  # (Nn, 3) f32
    first_tri: torch.Tensor  # (Nn,) i32
    miss: torch.Tensor  # (Nn,) i32
    tri_v0: torch.Tensor  # (Nt, 3) f32
    tri_e1: torch.Tensor  # (Nt, 3) f32
    tri_e2: torch.Tensor  # (Nt, 3) f32
    tri_id: torch.Tensor  # (Nt,) i32
    leaf_size: int

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def num_tri_slots(self) -> int:
        return self.tri_v0.shape[0]

    def to(self, device) -> "ThreadedBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "leaf_size"
        })


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = 16) -> ThreadedBVH:
    """Build a threaded BVH over (T, 3) world-space triangle vertices.

    The native builder (``accel/native.py``) when g++ is available, else the
    NumPy recursion; both give the same topology contract, and each is
    bit-equal to the JAX package's builder of the same kind."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    from . import native

    nat = native.bvh_build_native(v0, v1, v2, leaf_size)
    if nat is not None:
        node_min_a, node_max_a, first_a, miss_a, slots = nat
        return _finish(node_min_a, node_max_a, first_a, miss_a, slots, v0, v1, v2, leaf_size)

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = 0.5 * (tmin + tmax)

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    first_tri: list[int] = []
    subtree_end: list[int] = []
    tri_slots: list[int] = []  # original ids, -1 padding, leaf-contiguous

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(ids: np.ndarray) -> None:
        i = len(node_min)
        node_min.append(tmin[ids].min(axis=0))
        node_max.append(tmax[ids].max(axis=0))
        first_tri.append(-1)
        subtree_end.append(-1)
        if len(ids) <= leaf_size:
            first_tri[i] = len(tri_slots)
            tri_slots.extend(ids.tolist())
            tri_slots.extend([-1] * (leaf_size - len(ids)))
        else:
            c = centroid[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = len(ids) // 2
            part = np.argpartition(c[:, axis], mid)
            rec(ids[part[:mid]])
            rec(ids[part[mid:]])
        subtree_end[i] = len(node_min)

    rec(np.arange(T, dtype=np.int64))

    return _finish(
        np.stack(node_min),
        np.stack(node_max),
        np.asarray(first_tri, np.int32),
        np.asarray(subtree_end, np.int32),
        np.asarray(tri_slots, np.int32),
        v0, v1, v2, leaf_size,
    )


def refit_bvh(bvh: ThreadedBVH, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> ThreadedBVH:
    """Keep the topology, recompute the boxes and the leaf triangles: the
    reference's AccelerationStructure::update() (accelerationstructure.cpp:
    26-32; accel/bvh.py:151-214 of the JAX package).

    Leaf boxes come from the new vertices through the existing slot order;
    interior boxes are unioned in vectorised sweeps of ``box[i] =
    union(box[i + 1], box[miss[i + 1]])`` until nothing changes (the children
    of interior node ``i`` are ``i + 1`` and ``miss[i + 1]``).  The tree's
    quality degrades as the geometry drifts; ``build_bvh`` rebuilds it.
    Returns tensors on the device of ``bvh``."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    slots = bvh.tri_id.cpu().numpy()
    first = bvh.first_tri.cpu().numpy()
    miss = bvh.miss.cpu().numpy()
    k = bvh.leaf_size
    n_nodes = bvh.num_nodes

    safe = np.maximum(slots, 0)
    pad = (slots < 0)[:, None]
    tv0 = np.where(pad, 0.0, v0[safe]).astype(np.float32)
    te1 = np.where(pad, 0.0, (v1 - v0)[safe]).astype(np.float32)
    te2 = np.where(pad, 0.0, (v2 - v0)[safe]).astype(np.float32)

    smin = np.where(pad, np.inf, np.minimum(np.minimum(v0, v1), v2)[safe])
    smax = np.where(pad, -np.inf, np.maximum(np.maximum(v0, v1), v2)[safe])
    leaf_min = smin.reshape(-1, k, 3).min(axis=1)
    leaf_max = smax.reshape(-1, k, 3).max(axis=1)

    is_leaf = first >= 0
    nmin = np.full((n_nodes, 3), np.inf, np.float32)
    nmax = np.full((n_nodes, 3), -np.inf, np.float32)
    nmin[is_leaf] = leaf_min[first[is_leaf] // k]
    nmax[is_leaf] = leaf_max[first[is_leaf] // k]
    interior = np.nonzero(~is_leaf)[0]
    left = interior + 1
    right = miss[left]
    for _ in range(64):  # >= the tree's depth; ends early once converged
        new_min = np.minimum(nmin[left], nmin[right])
        new_max = np.maximum(nmax[left], nmax[right])
        if np.array_equal(new_min, nmin[interior]) and np.array_equal(new_max, nmax[interior]):
            break
        nmin[interior] = new_min
        nmax[interior] = new_max

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=bvh.tri_id.device)

    return dataclasses.replace(bvh, aabb_min=t(nmin), aabb_max=t(nmax), tri_v0=t(tv0),
                               tri_e1=t(te1), tri_e2=t(te2))


def treelet_cut(first_tri, miss, leaf_size: int, max_tris: int) -> np.ndarray:
    """Treelet frontier: the maximal subtrees holding <= ``max_tris`` slots
    (accel/bvh.py:217).  Every leaf lies in exactly one treelet, and each
    treelet ``[i, miss[i])`` is contiguous in every octant stream.  Returns
    the treelet root node ids, preorder-ascending."""
    first_tri = np.asarray(first_tri)
    miss = np.asarray(miss)
    n = first_tri.shape[0]
    pref = np.zeros(n + 1, np.int64)
    np.cumsum(first_tri >= 0, out=pref[1:])
    out: list[int] = []
    stack = [0]
    while stack:
        i = stack.pop()
        tris = (pref[miss[i]] - pref[i]) * leaf_size
        if tris <= max_tris or first_tri[i] >= 0:
            out.append(i)
        else:
            # children of interior i are i+1 and miss[i+1]; push right first
            stack.append(miss[i + 1])
            stack.append(i + 1)
    return np.asarray(sorted(out), np.int64)


def octant_permutations(aabb_min, aabb_max, first_tri, miss) -> np.ndarray:
    """Near-child-first preorders for the 8 direction octants
    (accel/bvh.py:251): octant ``o`` (bit k set <=> d[k] < 0) visits first
    the child whose box centre lies nearer along the signs of ``o``.
    Returns (8, Nn) int32 with ``perm[o, new_index] = old_index``."""
    first_tri = np.asarray(first_tri)
    miss = np.asarray(miss)
    n = first_tri.shape[0]
    center = 0.5 * (np.asarray(aabb_min) + np.asarray(aabb_max))
    size = miss - np.arange(n)  # subtree node count, invariant under swaps
    interior = first_tri < 0
    left = np.where(interior, np.arange(n) + 1, -1)
    right = np.where(interior, miss[np.minimum(left, n - 1)], -1)

    il = left[interior]
    ir = right[interior]
    proj_delta = center[ir] - center[il]  # (Ni, 3)
    imap = np.cumsum(interior) - 1  # node index -> interior-compressed index

    perms = np.empty((8, n), np.int64)
    for o in range(8):
        sgn = np.array(
            [1 - 2 * (o & 1), 1 - 2 * ((o >> 1) & 1), 1 - 2 * ((o >> 2) & 1)],
            np.float32,
        )
        swap = proj_delta @ sgn < 0.0  # right child nearer -> visit first
        first_c = np.where(swap, ir, il)
        second_c = np.where(swap, il, ir)
        pos = np.full(n, -1, np.int64)
        pos[0] = 0
        frontier = np.array([0], np.int64)
        while frontier.size:
            f = frontier[interior[frontier]]
            if f.size == 0:
                break
            fi = imap[f]
            fc, sc = first_c[fi], second_c[fi]
            pos[fc] = pos[f] + 1
            pos[sc] = pos[f] + 1 + size[fc]
            frontier = np.concatenate([fc, sc])
        perm = np.empty(n, np.int64)
        perm[pos] = np.arange(n)
        perms[o] = perm
    return perms.astype(np.int32)


def _finish(node_min, node_max, first_tri, miss, slots, v0, v1, v2, leaf_size):
    safe = np.maximum(slots, 0)
    pad = (slots < 0)[:, None]
    tv0 = np.where(pad, 0.0, v0[safe]).astype(np.float32)
    te1 = np.where(pad, 0.0, (v1 - v0)[safe]).astype(np.float32)
    te2 = np.where(pad, 0.0, (v2 - v0)[safe]).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a, dtype)))

    return ThreadedBVH(
        aabb_min=t(node_min, np.float32),
        aabb_max=t(node_max, np.float32),
        first_tri=t(first_tri, np.int32),
        miss=t(miss, np.int32),
        tri_v0=t(tv0, np.float32),
        tri_e1=t(te1, np.float32),
        tri_e2=t(te2, np.float32),
        tri_id=t(slots, np.int32),
        leaf_size=leaf_size,
    )
