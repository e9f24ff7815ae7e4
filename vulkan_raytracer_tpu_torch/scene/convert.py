"""Carry scene tables over from the JAX package.

:func:`tables_from_numpy` builds the port's
:class:`~vulkan_raytracer_tpu_torch.scene.scenegraph.SceneTables` from a JAX
``SceneTables`` whose array leaves have been turned into numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, tables)``).  It reads attributes
only and imports no jax, so the same scene data can feed both packages.
The JAX ``ThreadedBVH`` is carried over bit for bit, and the port builds its
own BVH streams from it (``ops/traverse.py``) under the port's upload rule;
the emissive-only ``ebvh`` always comes along.  Instanced tables
(``src.inst``) come along too: the groups with their transforms and boxes,
each BLAS bit for bit with streams built from it, and a dense prototype's
sweep table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import ThreadedBVH
from ..ops import dense
from ..ops.instanced import InstanceGroup, InstanceTables, group_table, union_box
from ..ops.math3 import V3
from ..ops.texture import EnvMap, TextureAtlas
from ..ops.traverse import TREELET_TRIS, build_streams
from .scenegraph import (AlphaTables, EmissivePDFTables, MaterialTable, SceneTables,
                         target_device)

#: SceneTables fields that are not arrays (counts and flags)
_STATIC = ("num_point", "num_directional", "num_emissive_tris",
           "has_alpha", "has_blend", "has_textures")


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed RGBA8 texels: the port keeps their bits in int32
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def _v3(v, device) -> V3:
    return V3(_tensor(v.x, device), _tensor(v.y, device), _tensor(v.z, device))


def _record(cls, src, device):
    """Build dataclass ``cls`` from the same-named attributes of ``src``."""
    out = {}
    for f in dataclasses.fields(cls):
        val = getattr(src, f.name)
        out[f.name] = _v3(val, device) if f.type == "V3" else _tensor(val, device)
    return cls(**out)


def _bvh_from_numpy(src) -> ThreadedBVH:
    """The port's ThreadedBVH, on the CPU, from a numpy-leaved JAX one (bit
    for bit)."""
    return ThreadedBVH(
        **{f.name: _tensor(getattr(src, f.name), "cpu")
           for f in dataclasses.fields(ThreadedBVH) if f.name != "leaf_size"},
        leaf_size=int(src.leaf_size),
    )


def _inst_from_numpy(src, cols, device, max_tris: int) -> InstanceTables:
    """The port's InstanceTables from a numpy-leaved JAX one; ``cols`` is
    the port's prototype columns (v0, v1, v2) on ``device``.  The union box,
    which the JAX tables do not carry, is made from the groups' boxes."""
    groups = []
    for g in src.groups:
        blas = pblas = table = None
        if g.blas is not None:
            blas = _bvh_from_numpy(g.blas)
            pblas = build_streams(blas, max_tris=max_tris).to(device)
            blas = blas.to(device)
        else:
            table = group_table(*cols, int(g.tri_off), int(g.tri_cnt))
        groups.append(InstanceGroup(
            inv=_tensor(g.inv, device), aabb_min=_tensor(g.aabb_min, device),
            aabb_max=_tensor(g.aabb_max, device), inst_id=_tensor(g.inst_id, device),
            blas=blas, pblas=pblas, table=table,
            tri_off=int(g.tri_off), tri_cnt=int(g.tri_cnt),
        ))
    box = union_box(np.concatenate([np.asarray(g.aabb_min) for g in src.groups]),
                    np.concatenate([np.asarray(g.aabb_max) for g in src.groups]))
    return InstanceTables(
        groups=tuple(groups),
        inv_flat=_tensor(src.inv_flat, device), nrm_flat=_tensor(src.nrm_flat, device),
        box=_tensor(box, device),
        num_instances=int(src.num_instances), num_proto_tris=int(src.num_proto_tris),
    )


def tables_from_numpy(src, device="cuda", traversal: str = "auto",
                      max_tris: int = TREELET_TRIS) -> SceneTables:
    """The port's SceneTables, on ``device``, from numpy-leaved JAX tables.
    As ``Scene.upload``, it goes to the card unless the caller asks for
    ``device="cpu"``.

    As ``Scene.upload`` does, the BVH and its streams (cut at ``max_tris``
    triangle slots per treelet) come along for scenes above
    ``DENSE_MAX_TRIS`` triangles, or for any scene with ``traversal="bvh"``.
    Instanced tables bring their groups instead (the JAX placeholders for
    ``bvh`` and ``pbvh`` are dropped), each BLAS with streams cut at
    ``max_tris``.
    """
    device = target_device(device)
    sky = src.skybox
    fields = {}
    instanced = getattr(src, "inst", None) is not None
    if traversal not in ("auto", "bvh"):
        raise ValueError(f"traversal must be 'auto' or 'bvh', not {traversal!r}")
    if not instanced and (traversal == "bvh"
                          or np.asarray(src.v0.x).shape[0] > dense.DENSE_MAX_TRIS):
        bvh = _bvh_from_numpy(src.bvh)
        fields["bvh"] = bvh.to(device)
        fields["pbvh"] = build_streams(bvh, max_tris=max_tris).to(device)
    fields["ebvh"] = _bvh_from_numpy(src.ebvh).to(device)
    for f in dataclasses.fields(SceneTables):
        name = f.name
        if name in ("bvh", "pbvh", "ebvh", "inst"):
            continue
        val = getattr(src, name)
        if name in _STATIC:
            fields[name] = val
        elif name == "materials":
            fields[name] = _record(MaterialTable, val, device)
        elif name == "alpha":
            fields[name] = _record(AlphaTables, val, device)
        elif name == "em_tables":
            fields[name] = _record(EmissivePDFTables, val, device)
        elif name == "tex":
            fields[name] = _record(TextureAtlas, val, device)
        elif name == "skybox":
            fields[name] = EnvMap(
                r=_tensor(sky.r, device), g=_tensor(sky.g, device), b=_tensor(sky.b, device),
                h=int(sky.h), w=int(sky.w),
            )
        elif name == "skybox_strength":
            fields[name] = torch.tensor(float(np.asarray(val)), dtype=torch.float32,
                                        device=device)
        elif f.type == "V3":
            fields[name] = _v3(val, device)
        else:
            fields[name] = _tensor(val, device)
    if instanced:
        fields["inst"] = _inst_from_numpy(
            src.inst, (fields["v0"], fields["v1"], fields["v2"]), device, max_tris)
    return SceneTables(**fields)
