"""Carry scene tables over from the JAX package.

:func:`tables_from_numpy` builds the port's
:class:`~vulkan_raytracer_tpu_torch.scene.scenegraph.SceneTables` from a JAX
``SceneTables`` whose array leaves have been turned into numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, tables)``).  It reads attributes
only and imports no jax, so the same scene data can feed both packages.
The JAX ``ThreadedBVH`` is carried over bit for bit, and the port builds its
own BVH streams from it (``ops/traverse.py``) under the port's upload rule;
the emissive-only ``ebvh`` always comes along.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import ThreadedBVH
from ..ops import dense
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


def tables_from_numpy(src, device="cuda", traversal: str = "auto",
                      max_tris: int = TREELET_TRIS) -> SceneTables:
    """The port's SceneTables, on ``device``, from numpy-leaved JAX tables.
    As ``Scene.upload``, it goes to the card unless the caller asks for
    ``device="cpu"``.

    As ``Scene.upload`` does, the BVH and its streams (cut at ``max_tris``
    triangle slots per treelet) come along for scenes above
    ``DENSE_MAX_TRIS`` triangles, or for any scene with ``traversal="bvh"``.
    """
    device = target_device(device)
    sky = src.skybox
    fields = {}
    if traversal == "bvh" or np.asarray(src.v0.x).shape[0] > dense.DENSE_MAX_TRIS:
        bvh = _bvh_from_numpy(src.bvh)
        fields["bvh"] = bvh.to(device)
        fields["pbvh"] = build_streams(bvh, max_tris=max_tris).to(device)
    elif traversal != "auto":
        raise ValueError(f"traversal must be 'auto' or 'bvh', not {traversal!r}")
    fields["ebvh"] = _bvh_from_numpy(src.ebvh).to(device)
    for f in dataclasses.fields(SceneTables):
        name = f.name
        if name in ("bvh", "pbvh", "ebvh"):
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
    return SceneTables(**fields)
