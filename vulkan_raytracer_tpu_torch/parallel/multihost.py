"""Fleets of processes: the scene broadcast and the per-rank pixel shards.

Port of :mod:`vulkan_raytracer_tpu.parallel.multihost` on
``torch.distributed``.  Every rank owns a contiguous run of the shards of
:mod:`.sharding` (rank ``r`` the shards ``[r * L, (r + 1) * L)`` of a mesh
that lists each rank's ``L`` devices), and the fleet adds the two pieces that
exist only across processes:

* the scene broadcast (:func:`broadcast_scene_tables`): every process builds
  the scene from the same file, but the threaded BVH builder and host
  floating point are not guaranteed to give the same bytes everywhere, so
  rank 0's tables go to the fleet and every rank traverses the same scene;
* the image gather (:func:`render_image_multihost`): each rank's shards are
  all-gathered, so every rank returns the full image, and the ray counters
  are summed with one all-reduce.

The process group is formed by the caller (``torch.distributed.
init_process_group``, as ``jax.distributed.initialize`` is in the JAX
package).  Without one the world is one process and every function is the
single-process one.  The backend is gloo, with CUDA tensors staged through
host memory: NCCL refuses two ranks on one GPU ("Duplicate GPU detected"),
which is how a machine with one card runs a fleet; the JAX gather ends on the
host anyway (``process_allgather``); and one backend then serves the CPU
and the card.  A collective that fails raises: the fleet does not go on
without a peer.
"""

from __future__ import annotations

import zlib

import torch
import torch.distributed as dist

from ..scene.scenegraph import map_tables
from .sharding import make_mesh, render_image_sharded


def _rank_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_ranks(value: int) -> list[int]:
    """``value`` of every rank, in rank order."""
    mine = torch.tensor([value], dtype=torch.int64)
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [int(x) for x in out]


def make_fleet_mesh(devices=None) -> list[torch.device]:
    """This process's devices (``sharding.make_mesh(devices)``: every visible
    card by default), once per rank in rank order, so that the shard list has
    the same length and order on every rank and rank ``r`` owns shards
    ``[r * L, (r + 1) * L)``.  Every rank must hold the same number ``L``."""
    local = make_mesh(devices)
    _, world = _rank_world()
    if world == 1:
        return local
    counts = _all_ranks(len(local))
    if len(set(counts)) != 1:
        raise RuntimeError(f"the ranks hold different numbers of devices: {counts}")
    return local * world


def _structure(tables) -> str:
    """The tables' static structure: field names, tensor shapes and dtypes,
    and every other leaf (counts, flags, None), in the order
    ``scenegraph.map_tables`` walks them."""
    lines = []

    def describe(path, leaf):
        if isinstance(leaf, torch.Tensor):
            lines.append(f"{path}: {leaf.dtype} {tuple(leaf.shape)}")
        else:
            lines.append(f"{path} = {leaf!r}")
        return leaf

    map_tables(tables, describe)
    return "\n".join(lines)


def _broadcast(path, leaf):
    """Rank 0's copy of a tensor leaf, on this rank's device (staged through
    host memory); other leaves as they are."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    host = leaf.detach().to("cpu", copy=True).contiguous()
    # gloo moves bytes; a bool tensor travels as its uint8 view
    dist.broadcast(host.view(torch.uint8) if host.dtype == torch.bool else host, src=0)
    return host.to(leaf.device)


def broadcast_scene_tables(tables):
    """Rank 0's ``SceneTables`` on every rank.

    With one process, ``tables`` itself.  Otherwise the ranks first compare a
    crc32 of the tables' static structure (:func:`_structure`) and raise if
    any differs; then every tensor leaf (triangle columns, materials, BVH
    streams, the emissive BVH, instance groups, the texture atlas) is
    broadcast from rank 0.  Returns new tables: the cached ``tri_table``,
    ``em_table`` and ``em_stream`` of a rank's own tables do not survive."""
    _, world = _rank_world()
    if world == 1:
        return tables
    # crc32, not hash(): Python salts string hashes per process
    crcs = _all_ranks(zlib.crc32(_structure(tables).encode()))
    if len(set(crcs)) != 1:
        raise RuntimeError(f"the ranks' scene tables differ in structure (crc32 {crcs})")
    return map_tables(tables, _broadcast)


def render_image_multihost(tables, camera, width: int, height: int, spp: int, max_depth: int,
                           mesh=None, start_sample: int = 1, tonemap: bool = True,
                           nee_weighting: str = "reference"):
    """Headless fleet render; the contract of
    ``sharding.render_image_sharded`` over the fleet's mesh (default
    :func:`make_fleet_mesh`).  Every rank renders its own shards and returns
    the full image and the fleet's ray count."""
    if mesh is None:
        mesh = make_fleet_mesh()
    rank, world = _rank_world()
    if world == 1:
        return render_image_sharded(tables, camera, width, height, spp, max_depth, mesh,
                                    start_sample=start_sample, tonemap=tonemap,
                                    nee_weighting=nee_weighting)
    if len(mesh) % world:
        raise ValueError(f"a mesh of {len(mesh)} shards does not split over {world} ranks")
    local = len(mesh) // world

    def gather(block):
        host = block.cpu().contiguous()
        out = [torch.empty_like(host) for _ in range(world)]
        dist.all_gather(out, host)
        return torch.cat(out).numpy()

    img, rays = render_image_sharded(tables, camera, width, height, spp, max_depth, mesh,
                                     start_sample=start_sample, tonemap=tonemap,
                                     nee_weighting=nee_weighting, gather=gather,
                                     shards=range(rank * local, (rank + 1) * local))
    total = torch.tensor([rays], dtype=torch.int64)
    dist.all_reduce(total)
    return img, int(total)


def is_io_host() -> bool:
    """True on the rank that owns file output: rank 0.  The render itself is
    the same on every rank."""
    return _rank_world()[0] == 0
