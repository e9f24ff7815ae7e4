"""Scene graph, glTF import and the flat upload to torch tables.

Port of :mod:`vulkan_raytracer_tpu.scene.scenegraph` without jax: the host
PODs (:class:`Material`, :class:`PointLight`, :class:`DirectionalLight`,
:class:`Primitive`), the node tree of :class:`Scene`, glTF import
(``load_model`` with its material, image and node helpers,
scenegraph.py:371-538), the material table (``_build_material_table``,
scenegraph.py:626-678) and the flattened upload (``_upload_flattened``,
scenegraph.py:1101-1300), which emits world-space triangle columns, the
emissive CDF and the pdf-probe tables in DFS order.

Scenes above ``DENSE_MAX_TRIS`` triangles (or any scene uploaded with
``traversal="bvh"``) also get their threaded BVH (``accel/bvh.py``) and its
per-octant streams (``ops/traverse.py``), which the integrator walks with the
BVH kernels; smaller scenes take the dense sweeps.  Every scene also gets
the BVH over its emissive triangles (``ebvh``, leaf size 4), which the pdf
probe walks when there are more than ``EMISSIVE_MAX_TRIS`` of them.

A scene whose nodes share meshes can be uploaded instanced instead
(``_upload_instanced``, scenegraph.py:866-1099): each unique primitive's
triangles are stored once in object space and every (node, primitive) pair
becomes an instance with its transform and world box (``SceneTables.inst``,
``ops/instanced.py``).  ``upload(instancing="auto")`` picks that when the
flattened soup would be large and mostly duplicates (``_should_instance``).
After nodes moved, :meth:`Scene.refit` refreshes the tables without
rebuilding a tree (scenegraph.py:542-624, :737-794).  Not ported: the grid
(the do-not-port list).

:class:`SceneTables` keeps the JAX field names, so the NumPy oracle
(``vulkan_raytracer_tpu.render.oracle``), which duck-types its input, reads
``tables.to("cpu")`` directly.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..accel import native
from ..accel.bvh import ThreadedBVH, build_bvh, refit_bvh
from ..ops import dense, traverse
from ..ops.instanced import InstanceGroup, InstanceTables, group_table, union_box
from ..ops.math3 import V3
from ..ops.texture import EnvMap, TextureAtlas, pack_envmap, pack_textures
from ..utils import image as image_io
from ..utils import logging as log
from . import gltf as gltf_mod

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)

#: 'auto' instancing threshold: flatten unless the world-space soup would
#: exceed this AND duplication contributes at least half of it.
INSTANCE_AUTO_MIN_FLATTENED = 1_000_000


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device must exist: the port
    never falls back to the CPU, which a caller asks for with ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device here; pass device='cpu' for the plain PyTorch path")
    return device


# ---------------------------------------------------------------------------
# Host-side PODs (material.h / light.h equivalents)
# ---------------------------------------------------------------------------


@dataclass
class Material:
    """Host material mirroring include/material.h:5-18 (+ glTF defaults);
    the JAX module's scenegraph.py:55-91."""

    base_colour_factor: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    alpha_mode: int = 0  # 0=OPAQUE 1=MASK 2=BLEND
    alpha_cutoff: float = 0.5
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    transmission_factor: float = 0.0
    thickness_factor: float = 0.0
    attenuation_coefficient: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    ior: float = 1.5
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0
    dispersion: float = 0.0
    base_colour_tex: int = -1
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    emissive_tex: int = -1
    transmission_tex: int = -1
    anisotropy_tex: int = -1

    @property
    def is_emissive(self) -> bool:
        return bool(np.any(self.emissive_factor != 0.0))


@dataclass
class PointLight:  # light.h:8-12
    position: np.ndarray
    colour: np.ndarray
    intensity: float
    range: float  # 0 = unbounded


@dataclass
class DirectionalLight:  # light.h:14-17
    direction: np.ndarray
    colour: np.ndarray
    intensity: float


@dataclass
class Primitive:
    """One mesh primitive's host arrays (mesh.h:9-23 equivalent)."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 4) f32, w = handedness sign, 0 if absent
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (3F,) u32
    material: int


@dataclass
class SceneObject:
    """Scene-graph node (scene.h:22-37): transform + optional mesh."""

    local_transform: np.ndarray
    world_transform: np.ndarray
    mesh: int = -1  # index into Scene.mesh_pool, -1 = none
    depth: int = 0
    parent: "SceneObject | None" = None
    children: list["SceneObject"] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------


def map_tables(x, fn, path: str = "tables"):
    """A table tree (dataclasses, V3s, tuples) rebuilt with each leaf (a
    tensor, a count, a flag, None) replaced by ``fn(path, leaf)``, where
    ``path`` names the leaf (``tables.v0.x``).  The dataclasses are new
    objects, so their cached tables are built anew."""
    if isinstance(x, V3):
        return V3(*(map_tables(c, fn, f"{path}.{k}") for k, c in zip("xyz", x)))
    if isinstance(x, tuple):
        return tuple(map_tables(c, fn, f"{path}[{i}]") for i, c in enumerate(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: map_tables(getattr(x, f.name), fn, f"{path}.{f.name}")
            for f in dataclasses.fields(x)})
    return fn(path, x)


def _to(x, device):
    """Move a table tree's tensors to ``device`` (other leaves kept)."""
    return map_tables(x, lambda _, v: v.to(device) if isinstance(v, torch.Tensor) else v)


@dataclass(frozen=True)
class MaterialTable:
    """SoA material table — the mirror of SSBO binding 6; (M,) columns."""

    base_colour: V3
    base_alpha: torch.Tensor
    emissive: torch.Tensor  # (M, 3)
    emissive_v: V3
    metallic: torch.Tensor
    roughness: torch.Tensor
    transmission: torch.Tensor
    thin: torch.Tensor  # bool — thicknessFactor == 0 (hit.rchit:98)
    attenuation: V3
    ior: torch.Tensor
    aniso_strength: torch.Tensor
    aniso_rotation: torch.Tensor
    dispersion: torch.Tensor
    tex_idx: torch.Tensor  # (M, 6) i32: base/mr/normal/emissive/transmission/aniso


@dataclass(frozen=True)
class AlphaTables:
    """Per-triangle alpha-test data (ops/traverse.py:37-49 in the JAX package)."""

    mode: torch.Tensor  # (T,) i32: 0=OPAQUE, 1=MASK, 2=BLEND
    value: torch.Tensor  # (T,) f32
    cutoff: torch.Tensor  # (T,) f32


@dataclass(frozen=True)
class EmissivePDFTables:
    """Per-emissive-triangle data for the MIS pdf probe (ops/traverse.py:54-68)."""

    p_delta: torch.Tensor  # (Te,) f32 normalised CDF increment
    area: torch.Tensor  # (Te,) f32
    n0: torch.Tensor  # (Te, 3) f32 unnormalised world vertex normals
    n1: torch.Tensor
    n2: torch.Tensor


@dataclass(frozen=True)
class SceneTables:
    """Everything the integrator needs, flat on one device (the JAX
    SceneTables' fields, scenegraph.py:166-247, without the grid).  ``bvh``
    and ``pbvh`` (the BVH streams) are None for a scene on the dense path and
    for an instanced scene; ``ebvh`` is the BVH over the emissive triangles
    (its ``tri_id`` indexes ``em_tables``).

    ``inst`` is None for a scene flattened to world space.  When set, the
    triangle columns hold object-space prototypes, traversal goes through
    ``ops/instanced.py``, and hit ids are encoded ``instance *
    num_proto_tris + prototype_triangle``; the emissive rows (``em_*``,
    ``em_tables``, ``ebvh``) stay world-space, one per emissive instance
    triangle."""

    v0: V3
    v1: V3
    v2: V3
    n0: V3
    n1: V3
    n2: V3
    tg0: V3
    tg1: V3
    tg2: V3
    tg_sign: torch.Tensor
    uv: torch.Tensor  # (T, 6)
    tri_mat: torch.Tensor  # (T,) i32
    materials: MaterialTable
    alpha: AlphaTables
    pl_pos: V3
    pl_colour: V3
    pl_intensity: torch.Tensor
    pl_range: torch.Tensor
    dl_dir: V3
    dl_colour: V3
    dl_intensity: torch.Tensor
    em_cdf: torch.Tensor  # (Te,) cumulative, last == 1
    em_tables: EmissivePDFTables
    em_tri: torch.Tensor  # (Te,) i32 -> scene triangle id
    em_v0: V3
    em_v1: V3
    em_v2: V3
    em_uv: torch.Tensor  # (Te, 6)
    em_mat: torch.Tensor  # (Te,) i32
    skybox: EnvMap
    skybox_strength: torch.Tensor  # () f32
    tex: TextureAtlas
    num_point: int
    num_directional: int
    num_emissive_tris: int
    has_alpha: bool
    has_blend: bool
    has_textures: bool
    bvh: ThreadedBVH | None = None
    pbvh: traverse.BVHStreams | None = None
    ebvh: ThreadedBVH | None = None
    inst: InstanceTables | None = None

    @property
    def num_triangles(self) -> int:
        return self.v0.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.x.device

    def to(self, device) -> "SceneTables":
        return _to(self, torch.device(device))

    # The sweep kernels' triangle tables, built once per SceneTables on first
    # use (cached_property writes the instance dict, past the frozen setattr).

    @functools.cached_property
    def tri_table(self) -> torch.Tensor:
        """(9, T) float32 [v0, e1, e2] of every triangle (dense.closest_table)."""
        return dense.closest_table(self)

    @functools.cached_property
    def em_table(self) -> torch.Tensor:
        """(20, Te) float32 table of the emissive triangles (dense.pdf_table)."""
        return dense.pdf_table(self)

    @functools.cached_property
    def em_stream(self) -> traverse.EmissiveStream:
        """``ebvh`` and ``em_tables`` packed for the emissive-pdf walk
        (traverse.build_emissive_stream), on the tables' device."""
        return traverse.build_emissive_stream(self.ebvh, self.em_tables).to(self.device)


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


def _inv_transpose3(m4: np.ndarray) -> np.ndarray:
    """Normal-transform matrix: transpose(inverse(upper3x3)) (hit.rchit:59)."""
    return np.linalg.inv(m4[:3, :3]).T.astype(np.float32)


def _decompose_rotation(m4: np.ndarray) -> np.ndarray:
    """Rotation part of a T*R*S matrix: the column norms divided out (the
    reference's glm::decompose for light placement, scene.cpp:368-375)."""
    r = m4[:3, :3].astype(np.float64)
    norms = np.linalg.norm(r, axis=0)
    norms[norms == 0] = 1.0
    return (r / norms).astype(np.float32)


class Scene:
    """Scene graph + host pools; fill it, then :meth:`upload`."""

    def __init__(self) -> None:
        self.root = SceneObject(np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))
        self.mesh_pool: list[list[Primitive]] = []
        self.materials: list[Material] = []
        self.point_lights: list[PointLight] = []
        self.directional_lights: list[DirectionalLight] = []
        self.textures: list[np.ndarray] = []  # (H, W, 4) f32 each
        self.skybox: np.ndarray | None = None  # (H, W, 3) f32
        self.skybox_strength: float = 1.0
        self.upload_stats: dict = {}  # counts and set-up seconds of the last upload

    # -- graph ----------------------------------------------------------

    def add_node(self, parent: SceneObject, local: np.ndarray, mesh: int = -1) -> SceneObject:
        node = SceneObject(
            local_transform=np.asarray(local, np.float32),
            world_transform=(parent.world_transform @ local).astype(np.float32),
            mesh=mesh,
            depth=parent.depth + 1,
            parent=parent,
        )
        parent.children.append(node)
        return node

    def add_raw_mesh(self, positions, normals, indices, material: Material,
                     transform=None, uvs=None, tangents=None) -> None:
        """Register a raw triangle mesh as a single-primitive node under the
        root (scenegraph.py:312-354); the material is deduplicated by
        identity."""
        try:
            mat_idx = next(i for i, m in enumerate(self.materials) if m is material)
        except StopIteration:
            mat_idx = len(self.materials)
            self.materials.append(material)
        nv = positions.shape[0]
        prim = Primitive(
            positions=np.asarray(positions, np.float32),
            normals=np.asarray(normals, np.float32),
            tangents=(np.zeros((nv, 4), np.float32) if tangents is None
                      else np.asarray(tangents, np.float32)),
            uvs=np.zeros((nv, 2), np.float32) if uvs is None else np.asarray(uvs, np.float32),
            indices=np.asarray(indices, np.uint32),
            material=mat_idx,
        )
        self.mesh_pool.append([prim])
        t = np.eye(4, dtype=np.float32) if transform is None else transform
        self.add_node(self.root, t, mesh=len(self.mesh_pool) - 1)

    def iter_depth_first(self):
        """DFS preorder over the tree without recursion (the order of the
        reference's processModelRecursive, so emissive CDF rows line up)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    # -- import ----------------------------------------------------------

    def load_model(self, path: str | Path, transform: np.ndarray | None = None) -> None:
        """Import one glTF/GLB file under ``transform`` (scene.cpp:23-343;
        the JAX module's scenegraph.py:371-442)."""
        path = Path(path)
        log.info("Loading model %s", path.name)
        g = gltf_mod.GLTF.load(path)

        base_mesh = len(self.mesh_pool)
        base_material = len(self.materials)
        base_texture = len(self.textures)

        # meshes (scene.cpp:44-143)
        for mesh_i, gltf_mesh in enumerate(g.meshes):
            log.progress_bar(mesh_i + 1, len(g.meshes), text=gltf_mesh.get("name", ""))
            prims: list[Primitive] = []
            for prim in gltf_mesh.get("primitives", []):
                attrs = prim["attributes"]
                pos = g.accessor(attrs["POSITION"])[:, :3].astype(np.float32)
                nrm = g.accessor(attrs["NORMAL"])[:, :3].astype(np.float32)
                nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
                nv = pos.shape[0]
                uv = (g.accessor(attrs["TEXCOORD_0"])[:, :2].astype(np.float32)
                      if "TEXCOORD_0" in attrs else np.zeros((nv, 2), np.float32))
                tan = (g.accessor(attrs["TANGENT"]).astype(np.float32)
                       if "TANGENT" in attrs else np.zeros((nv, 4), np.float32))
                idx = g.primitive_indices(prim)
                mat = base_material + prim.get("material", 0)
                prims.append(Primitive(pos, nrm, tan, uv, idx, mat))
            self.mesh_pool.append(prims)

        # materials and their five KHR extensions (scene.cpp:148-231)
        for mat_i, gm in enumerate(g.materials):
            log.progress_bar(mat_i + 1, len(g.materials), text=gm.get("name", ""))
            self.materials.append(self._parse_material(g, gm, base_texture))
        if g.meshes and not g.materials:
            self.materials.append(Material())  # default for material-less primitives

        # images -> texture pool (scene.cpp:233-243)
        for img_i, img in enumerate(g.images):
            log.progress_bar(img_i + 1, len(g.images), text=img.get("uri", ""))
            self.textures.append(self._load_image(g, img))

        # punctual lights (scene.cpp:246-270); the node walk places them
        light_slots: list[tuple[str, int]] = []
        for gl in g.lights:
            colour = np.asarray(gl.get("color", [1, 1, 1]), np.float32)
            intensity = float(gl.get("intensity", 1.0))
            if gl.get("type") == "point":
                light_slots.append(("point", len(self.point_lights)))
                self.point_lights.append(PointLight(
                    np.zeros(3, np.float32), colour, intensity, float(gl.get("range", 0.0))))
            elif gl.get("type") == "directional":
                light_slots.append(("directional", len(self.directional_lights)))
                self.directional_lights.append(
                    DirectionalLight(np.array([0, 0, -1], np.float32), colour, intensity))
            else:  # spot lights: the reference ignores them too (scene.cpp:254-268)
                light_slots.append(("unsupported", -1))

        # node walk (scene.cpp:344-404)
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        model_root = self.add_node(self.root, transform)
        for node_idx in g.scene_root_nodes():
            self._process_node(model_root, g, g.nodes[node_idx], base_mesh, light_slots)
        log.info("Finished loading model %s", path.name)

    def _parse_material(self, g: gltf_mod.GLTF, gm: dict, base_tex: int) -> Material:
        """One glTF material with KHR_materials_emissive_strength,
        _transmission, _volume, _ior, _anisotropy and _dispersion
        (scenegraph.py:444-497)."""
        m = Material()
        pbr = gm.get("pbrMetallicRoughness", {})
        m.base_colour_factor = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        m.metallic_factor = float(pbr.get("metallicFactor", 1.0))
        m.roughness_factor = float(pbr.get("roughnessFactor", 1.0))

        def tex(src: dict | None) -> int:
            if not src:
                return -1
            return base_tex + g.textures[src["index"]].get("source", -1)

        m.base_colour_tex = tex(pbr.get("baseColorTexture"))
        m.metallic_roughness_tex = tex(pbr.get("metallicRoughnessTexture"))
        m.normal_tex = tex(gm.get("normalTexture"))
        m.emissive_tex = tex(gm.get("emissiveTexture"))

        m.alpha_mode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(gm.get("alphaMode", "OPAQUE"), 0)
        m.alpha_cutoff = float(gm.get("alphaCutoff", 0.5))
        m.emissive_factor = np.asarray(gm.get("emissiveFactor", [0, 0, 0]), np.float32)

        ext = gm.get("extensions", {})
        if "KHR_materials_emissive_strength" in ext:
            m.emissive_factor = m.emissive_factor * np.float32(
                ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0))
        if "KHR_materials_transmission" in ext:
            tr = ext["KHR_materials_transmission"]
            m.transmission_factor = float(tr.get("transmissionFactor", 0.0))
            m.transmission_tex = tex(tr.get("transmissionTexture"))
        if "KHR_materials_volume" in ext:
            vol = ext["KHR_materials_volume"]
            m.thickness_factor = float(vol.get("thicknessFactor", 0.0))
            att_dist = float(vol.get("attenuationDistance", np.inf))
            att_col = np.asarray(vol.get("attenuationColor", [1, 1, 1]), np.float64)
            # sigma = -log(colour) / distance (scene.cpp:209)
            with np.errstate(divide="ignore"):
                m.attenuation_coefficient = (
                    -np.log(np.maximum(att_col, 1e-30)) / att_dist).astype(np.float32)
        if "KHR_materials_ior" in ext:
            m.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
        if "KHR_materials_anisotropy" in ext:
            an = ext["KHR_materials_anisotropy"]
            m.anisotropy_strength = float(an.get("anisotropyStrength", 0.0))
            m.anisotropy_rotation = float(an.get("anisotropyRotation", 0.0))
            m.anisotropy_tex = tex(an.get("anisotropyTexture"))
        if "KHR_materials_dispersion" in ext:
            m.dispersion = float(ext["KHR_materials_dispersion"].get("dispersion", 0.0))
        return m

    def _load_image(self, g: gltf_mod.GLTF, img: dict) -> np.ndarray:
        """Decode one glTF image (external file, data URI or bufferView).  As
        the reference's loader does, an image that fails to decode is logged
        and becomes one white texel, and loading goes on."""
        uri = img.get("uri")
        try:
            if uri and not uri.startswith("data:"):
                return image_io.load_texture(g.base_dir / uri)
            if uri:  # data URI
                return image_io.decode_texture(base64.b64decode(uri.split(",", 1)[1]))
            bv = g.doc["bufferViews"][img["bufferView"]]
            off = bv.get("byteOffset", 0)
            return image_io.decode_texture(g.buffers[bv["buffer"]][off:off + bv["byteLength"]])
        except Exception as e:
            log.error("Failed to load image %s: %s", uri or "<bufferView>", e)
            return np.ones((1, 1, 4), np.float32)

    def _process_node(self, parent, g, node, base_mesh, light_slots) -> None:
        """Add ``node`` and its subtree; place the lights it carries
        (scene.cpp:344-404)."""
        local = gltf_mod.node_local_transform(node)
        so = self.add_node(parent, local, base_mesh + node["mesh"] if "mesh" in node else -1)
        world = so.world_transform

        light = g.node_light(node)
        if 0 <= light < len(light_slots):
            kind, idx = light_slots[light]
            if kind == "point":
                self.point_lights[idx].position = world[:3, 3].copy()
            elif kind == "directional":
                rot = _decompose_rotation(world)
                self.directional_lights[idx].direction = (
                    rot @ np.array([0, 0, -1], np.float32)).astype(np.float32)

        for child in node.get("children", []):
            self._process_node(so, g, g.nodes[child], base_mesh, light_slots)

    # -- upload ------------------------------------------------------------

    def _build_material_table(self, device):
        """MaterialTable + per-material alpha columns (scenegraph.py:626-678)."""
        mats = self.materials or [Material()]

        def col(values, dtype=np.float32):
            return torch.as_tensor(np.array(values, dtype), device=device)

        def vcol(rows):  # list of (3,) -> V3 of (M,)
            a = np.stack(rows).astype(np.float32)
            return V3(*(torch.as_tensor(a[:, k].copy(), device=device) for k in range(3)))

        mt = MaterialTable(
            base_colour=vcol([m.base_colour_factor[:3] for m in mats]),
            base_alpha=col([m.base_colour_factor[3] for m in mats]),
            emissive=torch.as_tensor(
                np.stack([m.emissive_factor for m in mats]).astype(np.float32), device=device
            ),
            emissive_v=vcol([m.emissive_factor for m in mats]),
            metallic=col([m.metallic_factor for m in mats]),
            roughness=col([m.roughness_factor for m in mats]),
            transmission=col([m.transmission_factor for m in mats]),
            thin=col([m.thickness_factor == 0.0 for m in mats], bool),
            attenuation=vcol([m.attenuation_coefficient for m in mats]),
            ior=col([m.ior for m in mats]),
            aniso_strength=col([m.anisotropy_strength for m in mats]),
            aniso_rotation=col([m.anisotropy_rotation for m in mats]),
            dispersion=col([m.dispersion for m in mats]),
            tex_idx=col(
                [[m.base_colour_tex, m.metallic_roughness_tex, m.normal_tex,
                  m.emissive_tex, m.transmission_tex, m.anisotropy_tex] for m in mats],
                np.int32,
            ),
        )
        mode_by_mat = np.array([m.alpha_mode for m in mats], np.int32)
        aval_by_mat = np.array([m.base_colour_factor[3] for m in mats], np.float32)
        acut_by_mat = np.array([m.alpha_cutoff for m in mats], np.float32)
        return mt, mode_by_mat, aval_by_mat, acut_by_mat

    def _iter_instances(self):
        """(node, prim) pairs in DFS preorder: the reference's TLAS instance
        order, one instance per node x primitive
        (accelerationstructure.cpp:157-177)."""
        for node in self.iter_depth_first():
            if node.mesh < 0:
                continue
            for prim in self.mesh_pool[node.mesh]:
                yield node, prim

    def _should_instance(self, instancing) -> bool:
        """Flatten, or keep instances (scenegraph.py:690-715)?

        Flattening is the default; its memory is O(instances x triangles).
        ``"auto"`` switches to instancing when the flattened soup would be
        both large (above ``INSTANCE_AUTO_MIN_FLATTENED`` triangles) and at
        least half duplicates.  ``VKRT_INSTANCING=0/1`` overrides, as in the
        JAX package."""
        env = os.environ.get("VKRT_INSTANCING")
        if env is not None and env != "":
            return env not in ("0", "false", "no")
        if instancing in (True, False):
            return instancing
        flat = 0
        unique = 0
        seen: set[int] = set()
        for _node, prim in self._iter_instances():
            nt = prim.indices.shape[0] // 3
            flat += nt
            if id(prim) not in seen:
                seen.add(id(prim))
                unique += nt
        return flat > INSTANCE_AUTO_MIN_FLATTENED and flat >= 2 * unique

    def upload(self, device="cuda", traversal: str = "auto", instancing="auto") -> SceneTables:
        """Build the tables on ``device`` (Scene::uploadResources,
        scene.cpp:281-342, with the acceleration structures).

        ``instancing``: False flattens every (node, primitive) instance to
        world space; True keeps shared geometry once with per-instance
        transforms (O(triangles + instances) memory, ``ops/instanced.py``);
        ``"auto"`` flattens unless the duplication is large
        (:meth:`_should_instance`).

        ``traversal="auto"`` builds the BVH and its streams for scenes (when
        instanced: for prototypes) above ``DENSE_MAX_TRIS`` triangles;
        ``"bvh"`` builds them for any (the explicit form of the JAX package's
        ``VKRT_FORCE_PACKET``).  The seconds of the BVH build, the stream
        build and the copy of both to the device are logged and kept in
        ``self.upload_stats``, with the bytes the streams take there.  The
        tables go to the card unless the caller asks for ``device="cpu"``;
        without a card that default raises."""
        if traversal not in ("auto", "bvh"):
            raise ValueError(f"traversal must be 'auto' or 'bvh', not {traversal!r}")
        device = target_device(device)
        if self._should_instance(instancing):
            return self._upload_instanced(device, traversal)
        return self._upload_flattened(device, traversal)

    def _flatten(self):
        """World-space triangles of every (node, primitive) instance in DFS
        order: (v0, v1, v2, normals (T, 3, 3), tangents (T, 3, 3)), float32."""
        v0s, v1s, v2s, n_tris, tg_tris = [], [], [], [], []
        for node in self.iter_depth_first():
            if node.mesh < 0:
                continue
            world = node.world_transform
            nrm_m = _inv_transpose3(world)
            for prim in self.mesh_pool[node.mesh]:
                idx = prim.indices.reshape(-1, 3)
                pos_w = prim.positions @ world[:3, :3].T + world[:3, 3]
                nrm_w = prim.normals @ nrm_m.T
                tan_w = prim.tangents[:, :3] @ nrm_m.T
                v0s.append(pos_w[idx[:, 0]])
                v1s.append(pos_w[idx[:, 1]])
                v2s.append(pos_w[idx[:, 2]])
                n_tris.append(np.stack([nrm_w[idx[:, k]] for k in range(3)], axis=1))
                tg_tris.append(np.stack([tan_w[idx[:, k]] for k in range(3)], axis=1))
        if not v0s:
            raise ValueError("scene contains no triangles")
        return tuple(np.concatenate(a).astype(np.float32)
                     for a in (v0s, v1s, v2s, n_tris, tg_tris))

    def _emissive_fields(self, em_heuristic, em_tri_ids, em_rows, placeholder, t, vcomp,
                         device) -> dict:
        """The emissive CDF (normalised, scene.cpp:288-292), the pdf-probe
        tables, the emissive BVH and the world-space emissive rows, as
        SceneTables fields.  ``em_rows()`` gives (ev0, ev1, ev2, normals
        (Te, 3, 3), uv (Te, 6), material ids) of the emissive triangles;
        ``placeholder`` is the single row (ev0, ev1, ev2, uv, material) a
        scene without emissive triangles carries, as the JAX upload does."""
        if em_heuristic:
            h = np.concatenate(em_heuristic)
            em_tri = np.concatenate(em_tri_ids)
            cdf = np.cumsum(h, dtype=np.float64)
            total = cdf[-1] if cdf[-1] > 0 else 1.0
            cdf = (cdf / total).astype(np.float32)
            p_delta = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
            ev0, ev1, ev2, en, em_uv, em_mat = em_rows()
            em_area = 0.5 * np.linalg.norm(np.cross(ev1 - ev0, ev2 - ev0), axis=-1).astype(
                np.float32
            )
            ebvh = build_bvh(ev0, ev1, ev2, leaf_size=4)
            em_tables = EmissivePDFTables(
                p_delta=t(p_delta), area=t(em_area),
                n0=t(en[:, 0]), n1=t(en[:, 1]), n2=t(en[:, 2]),
            )
            num_em = len(em_tri)
        else:  # placeholder single degenerate row; gated off by num_emissive_tris
            cdf = np.ones(1, np.float32)
            em_tri = np.zeros(1, np.int32)
            ev0, ev1, ev2, em_uv, em_mat = placeholder
            ebvh = build_bvh(*(np.zeros((1, 3), np.float32),) * 3, leaf_size=4)
            em_tables = EmissivePDFTables(
                p_delta=t(np.zeros(1, np.float32)), area=t(np.ones(1, np.float32)),
                n0=t(np.ones((1, 3), np.float32)), n1=t(np.ones((1, 3), np.float32)),
                n2=t(np.ones((1, 3), np.float32)),
            )
            num_em = 0
        return dict(
            em_cdf=t(cdf), em_tables=em_tables, em_tri=t(em_tri),
            em_v0=vcomp(ev0), em_v1=vcomp(ev1), em_v2=vcomp(ev2),
            em_uv=t(em_uv), em_mat=t(em_mat), ebvh=ebvh.to(device), num_emissive_tris=num_em,
        )

    def _shared_fields(self, tri_mat, t, vcomp, device) -> dict:
        """The SceneTables fields both uploads build alike: materials, the
        per-triangle alpha columns, lights, skybox and textures."""
        mt, mode_by_mat, aval_by_mat, acut_by_mat = self._build_material_table(device)

        def light_cols(rows, width):
            if rows:
                return np.stack(rows).astype(np.float32)
            return np.zeros((1, width), np.float32)

        def scalars(values):
            return np.array(values, np.float32) if values else np.zeros(1, np.float32)

        pls, dls = self.point_lights, self.directional_lights
        skybox = self.skybox if self.skybox is not None else np.zeros((1, 1, 3), np.float32)
        return dict(
            materials=mt,
            alpha=AlphaTables(
                mode=t(mode_by_mat[tri_mat]),
                value=t(aval_by_mat[tri_mat]),
                cutoff=t(acut_by_mat[tri_mat]),
            ),
            has_alpha=bool((mode_by_mat[tri_mat] != 0).any()),
            has_blend=bool((mode_by_mat[tri_mat] == 2).any()),
            pl_pos=vcomp(light_cols([l.position for l in pls], 3)),
            pl_colour=vcomp(light_cols([l.colour for l in pls], 3)),
            pl_intensity=t(scalars([l.intensity for l in pls])),
            pl_range=t(scalars([l.range for l in pls])),
            dl_dir=vcomp(light_cols([l.direction for l in dls], 3)),
            dl_colour=vcomp(light_cols([l.colour for l in dls], 3)),
            dl_intensity=t(scalars([l.intensity for l in dls])),
            skybox=pack_envmap(skybox, device),
            skybox_strength=torch.tensor(self.skybox_strength, dtype=torch.float32,
                                         device=device),
            tex=pack_textures(self.textures, device),
            num_point=len(pls),
            num_directional=len(dls),
            has_textures=bool(self.textures),
        )

    def _upload_flattened(self, device, traversal: str) -> SceneTables:
        """Flatten every (node, primitive) instance to world space (the JAX
        package's _upload_flattened, scenegraph.py:1101-1300)."""
        t, vcomp = _uploaders(device)
        v0, v1, v2, tri_n, tri_tg = self._flatten()
        uv_tris, sign_tris, mat_tris = [], [], []
        em_heuristic: list[np.ndarray] = []
        em_tri_ids: list[np.ndarray] = []
        tri_base = 0
        for _node, prim in self._iter_instances():
            idx = prim.indices.reshape(-1, 3)
            nt = idx.shape[0]
            uv_tris.append(np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1))
            sign_tris.append(prim.tangents[idx[:, 0], 3])
            mat_tris.append(np.full(nt, prim.material, np.int32))
            mat = self.materials[prim.material]
            if mat.is_emissive:
                sl = slice(tri_base, tri_base + nt)
                area = 0.5 * np.linalg.norm(np.cross(v1[sl] - v0[sl], v2[sl] - v0[sl]), axis=-1)
                h = area * float(mat.emissive_factor @ _LUMA)
                em_heuristic.append(h.astype(np.float32))
                em_tri_ids.append(np.arange(tri_base, tri_base + nt, dtype=np.int32))
            tri_base += nt

        tri_uv = np.concatenate(uv_tris).astype(np.float32)
        tri_sign = np.concatenate(sign_tris).astype(np.float32)
        tri_mat = np.concatenate(mat_tris)
        uv_flat = tri_uv.reshape(tri_uv.shape[0], 6)

        def em_rows():
            em_tri = np.concatenate(em_tri_ids)
            return (v0[em_tri], v1[em_tri], v2[em_tri], tri_n[em_tri], uv_flat[em_tri],
                    tri_mat[em_tri])

        emissive = self._emissive_fields(
            em_heuristic, em_tri_ids, em_rows,
            (v0[:1], v1[:1], v2[:1], uv_flat[:1], tri_mat[:1]),  # triangle 0 stands in
            t, vcomp, device)
        log.info(
            "Uploaded scene: %d tris, %d materials, %d point + %d directional lights, "
            "%d emissive tris (%s)",
            tri_base, max(len(self.materials), 1), len(self.point_lights),
            len(self.directional_lights), emissive["num_emissive_tris"], device,
        )

        bvh = pbvh = None
        self.upload_stats = {"triangles": tri_base}
        if traversal == "bvh" or tri_base > dense.DENSE_MAX_TRIS:
            bvh, pbvh = self._build_bvh(v0, v1, v2, device)

        return SceneTables(
            v0=vcomp(v0), v1=vcomp(v1), v2=vcomp(v2),
            n0=vcomp(tri_n[:, 0]), n1=vcomp(tri_n[:, 1]), n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]), tg1=vcomp(tri_tg[:, 1]), tg2=vcomp(tri_tg[:, 2]),
            tg_sign=t(tri_sign),
            uv=t(uv_flat),
            tri_mat=t(tri_mat),
            bvh=bvh,
            pbvh=pbvh,
            **emissive,
            **self._shared_fields(tri_mat, t, vcomp, device),
        )

    def _build_bvh(self, v0, v1, v2, device):
        """The threaded BVH and its streams on ``device``, timed apart."""
        t0 = time.perf_counter()
        bvh = build_bvh(v0, v1, v2)
        t1 = time.perf_counter()
        pbvh = traverse.build_streams(bvh)
        t2 = time.perf_counter()
        bvh, pbvh = bvh.to(device), pbvh.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        builder = "native" if native.get_lib() is not None else "numpy"
        stats = self.upload_stats
        for key, value in (("bvh_seconds", t1 - t0), ("streams_seconds", t2 - t1),
                           ("copy_seconds", t3 - t2), ("nodes", bvh.num_nodes),
                           ("treelets", pbvh.n_treelets), ("stream_bytes", pbvh.nbytes)):
            stats[key] = stats.get(key, 0) + value  # an instanced upload builds several
        stats["bvh_builder"] = builder
        log.info(
            "BVH: %d nodes, %d treelets, streams %d bytes; build %.3fs (%s builder), "
            "streams %.3fs, copy to %s %.3fs", bvh.num_nodes, pbvh.n_treelets, pbvh.nbytes,
            t1 - t0, builder, t2 - t1, device, t3 - t2,
        )
        return bvh, pbvh

    # -- instancing ----------------------------------------------------------

    def _proto_registry(self, instances):
        """Prototype registry in first-encounter DFS order (the layout of
        :meth:`_upload_instanced`; deterministic, so a refit finds it again)."""
        proto_idx: dict[int, int] = {}
        protos: list[Primitive] = []
        for _n, prim in instances:
            if id(prim) not in proto_idx:
                proto_idx[id(prim)] = len(protos)
                protos.append(prim)
        tri_off: list[int] = []
        proto_aabb: list[tuple[np.ndarray, np.ndarray]] = []
        off = 0
        for prim in protos:
            tri_off.append(off)
            off += prim.indices.shape[0] // 3
            proto_aabb.append((prim.positions.min(0), prim.positions.max(0)))
        return proto_idx, protos, tri_off, proto_aabb, off

    def _instance_pass(self, instances, proto_idx, tri_off, proto_aabb, num_proto_tris):
        """One DFS pass over the instances: transforms, world AABBs and the
        emissive world rows.  Shared by :meth:`_upload_instanced` and the
        O(instances) instanced refit; NumPy in the JAX package's operation
        order (the inverse in float64, then float32 rows), so the rows are
        bit-equal to its."""
        num_inst = len(instances)
        inv_rows = np.zeros((num_inst, 12), np.float32)
        nrm_rows = np.zeros((num_inst, 9), np.float32)
        inst_bmin = np.zeros((num_inst, 3), np.float32)
        inst_bmax = np.zeros((num_inst, 3), np.float32)
        members: list[list[int]] = [[] for _ in proto_aabb]
        em_heuristic: list[np.ndarray] = []
        em_tri_ids: list[np.ndarray] = []
        em_w: list[tuple] = []  # (v0, v1, v2, n, uv, mat) world rows
        corner_sel = np.array(
            [[(c >> a) & 1 for a in range(3)] for c in range(8)], np.float32
        )
        for gi, (node, prim) in enumerate(instances):
            w = node.world_transform
            inv_rows[gi] = np.linalg.inv(w.astype(np.float64))[:3, :].reshape(12)
            nrm_m = _inv_transpose3(w)
            nrm_rows[gi] = nrm_m.reshape(9)
            p = proto_idx[id(prim)]
            members[p].append(gi)
            bmin, bmax = proto_aabb[p]
            corners = bmin + corner_sel * (bmax - bmin)
            cw = corners @ w[:3, :3].T + w[:3, 3]
            inst_bmin[gi], inst_bmax[gi] = cw.min(0), cw.max(0)

            mat = self.materials[prim.material]
            if mat.is_emissive:
                idx = prim.indices.reshape(-1, 3)
                pos_w = prim.positions @ w[:3, :3].T + w[:3, 3]
                nrm_w = prim.normals @ nrm_m.T
                ev0, ev1, ev2 = (pos_w[idx[:, k]] for k in range(3))
                area = 0.5 * np.linalg.norm(np.cross(ev1 - ev0, ev2 - ev0), axis=-1)
                em_heuristic.append(
                    (area * float(mat.emissive_factor @ _LUMA)).astype(np.float32)
                )
                nt = idx.shape[0]
                enc0 = gi * num_proto_tris + tri_off[p]
                em_tri_ids.append(np.arange(enc0, enc0 + nt, dtype=np.int32))
                en = np.stack([nrm_w[idx[:, k]] for k in range(3)], axis=1)
                euv = np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1)
                em_w.append(
                    (ev0, ev1, ev2, en, euv.reshape(nt, 6),
                     np.full(nt, prim.material, np.int32))
                )
        return (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            em_heuristic, em_tri_ids, em_w,
        )

    def _upload_instanced(self, device, traversal: str) -> SceneTables:
        """O(triangles + instances) upload: object-space prototypes and the
        instance tables (scenegraph.py:866-1099; the reference's shared-BLAS
        design, accelerationstructure.cpp:96-177).

        Each unique primitive's triangles are stored once in object space;
        every (node, primitive) pair becomes an instance with a world->object
        transform, an inverse-transpose rotation for normals and a world
        AABB.  A prototype above ``DENSE_MAX_TRIS`` triangles gets its own
        BLAS and BVH streams.  Emissive geometry also gets per-instance
        world-space rows: the NEE CDF weighs by world area and must tell the
        instances apart, and the pdf probes run unchanged over them."""
        t, vcomp = _uploaders(device)
        instances = list(self._iter_instances())
        if not instances:
            raise ValueError("scene contains no triangles")
        proto_idx, protos, tri_off, proto_aabb, num_proto_tris = self._proto_registry(instances)

        # --- prototype triangle columns (object space) ---
        v0s, v1s, v2s, n_tris, tg_tris, uv_tris = [], [], [], [], [], []
        sign_tris, mat_tris = [], []
        for prim in protos:
            idx = prim.indices.reshape(-1, 3)
            pos, nrm, tan = prim.positions, prim.normals, prim.tangents
            v0s.append(pos[idx[:, 0]])
            v1s.append(pos[idx[:, 1]])
            v2s.append(pos[idx[:, 2]])
            n_tris.append(np.stack([nrm[idx[:, k]] for k in range(3)], axis=1))
            tg_tris.append(np.stack([tan[idx[:, k], :3] for k in range(3)], axis=1))
            uv_tris.append(np.stack([prim.uvs[idx[:, k]] for k in range(3)], axis=1))
            sign_tris.append(tan[idx[:, 0], 3])
            mat_tris.append(np.full(idx.shape[0], prim.material, np.int32))
        v0 = np.concatenate(v0s).astype(np.float32)
        v1 = np.concatenate(v1s).astype(np.float32)
        v2 = np.concatenate(v2s).astype(np.float32)
        tri_n = np.concatenate(n_tris).astype(np.float32)
        tri_tg = np.concatenate(tg_tris).astype(np.float32)
        tri_uv = np.concatenate(uv_tris).astype(np.float32)
        tri_sign = np.concatenate(sign_tris).astype(np.float32)
        tri_mat = np.concatenate(mat_tris)

        num_inst = len(instances)
        if num_inst * num_proto_tris >= 2**31:
            raise ValueError(
                f"instanced id space overflows int32: {num_inst} instances x "
                f"{num_proto_tris} prototype triangles"
            )

        # --- per-instance transforms and emissive world rows (DFS order) ---
        (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            em_heuristic, em_tri_ids, em_w,
        ) = self._instance_pass(instances, proto_idx, tri_off, proto_aabb, num_proto_tris)

        cols = (vcomp(v0), vcomp(v1), vcomp(v2))
        self.upload_stats = {"triangles": num_proto_tris, "instances": num_inst,
                             "prototypes": len(protos)}

        # --- instance groups, one per prototype ---
        groups = []
        for p, prim in enumerate(protos):
            gl = np.array(members[p], np.int32)
            cnt = prim.indices.shape[0] // 3
            blas = pblas = table = None
            if traversal == "bvh" or cnt > dense.DENSE_MAX_TRIS:
                s, e = tri_off[p], tri_off[p] + cnt
                blas, pblas = self._build_bvh(v0[s:e], v1[s:e], v2[s:e], device)
            else:
                table = group_table(*cols, tri_off[p], cnt)
            groups.append(InstanceGroup(
                inv=t(inv_rows[gl]), aabb_min=t(inst_bmin[gl]), aabb_max=t(inst_bmax[gl]),
                inst_id=t(gl), blas=blas, pblas=pblas, table=table,
                tri_off=tri_off[p], tri_cnt=cnt,
            ))
        inst_tables = InstanceTables(
            groups=tuple(groups),
            inv_flat=t(inv_rows.T), nrm_flat=t(nrm_rows.T), box=t(union_box(inst_bmin, inst_bmax)),
            num_instances=num_inst, num_proto_tris=num_proto_tris,
        )

        def em_rows():
            return tuple(np.concatenate([r[k] for r in em_w]).astype(dt)
                         for k, dt in enumerate((np.float32,) * 5 + (np.int32,)))

        zeros = np.zeros((1, 3), np.float32)
        emissive = self._emissive_fields(
            em_heuristic, em_tri_ids, em_rows,
            (zeros, zeros, zeros, np.zeros((1, 6), np.float32), np.zeros(1, np.int32)),
            t, vcomp, device)
        log.info(
            "Uploaded scene (instanced): %d prototype tris x %d instances "
            "(%d prototypes), %d emissive tris (%s)",
            num_proto_tris, num_inst, len(protos), emissive["num_emissive_tris"], device,
        )
        # the flattened structures (bvh, pbvh) stay None: the integrator
        # tests ``inst`` first
        return SceneTables(
            v0=cols[0], v1=cols[1], v2=cols[2],
            n0=vcomp(tri_n[:, 0]), n1=vcomp(tri_n[:, 1]), n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]), tg1=vcomp(tri_tg[:, 1]), tg2=vcomp(tri_tg[:, 2]),
            tg_sign=t(tri_sign),
            uv=t(tri_uv.reshape(tri_uv.shape[0], 6)),
            tri_mat=t(tri_mat),
            inst=inst_tables,
            **emissive,
            **self._shared_fields(tri_mat, t, vcomp, device),
        )

    # -- refit -----------------------------------------------------------------

    def refit(self, tables: SceneTables) -> SceneTables:
        """Cheap update after node transforms changed:
        AccelerationStructure::update() (accelerationstructure.cpp:26-32;
        scenegraph.py:542-624 of the JAX package).

        Re-flattens the world-space geometry and *refits* the BVH and the
        emissive BVH in place of a rebuild: topology and slot order are kept,
        only the boxes and the triangle data refresh, and the BVH streams are
        repacked from the refitted tree with the upload's treelet cut.  The
        result is a new ``SceneTables``; its kernel tables (``tri_table``,
        ``em_table``, ``em_stream``) are built anew on first use.  As in the
        reference's update(), the emissive CDF and areas and the light
        placements are not recomputed (scene.cpp:281-342).  The topology
        (triangle counts, mesh list, materials) must be unchanged, else
        ``ValueError``.

        Instanced tables refit in O(instances): the geometry is shared and
        object-space, so only the per-instance transforms, the world boxes,
        the emissive world rows and the emissive BVH refresh."""
        if tables.inst is not None:
            return self._refit_instanced(tables)
        device = tables.device
        t, vcomp = _uploaders(device)
        v0, v1, v2, tri_n, tri_tg = self._flatten()
        if v0.shape[0] != tables.num_triangles:
            raise ValueError("refit requires unchanged topology; use upload()")

        bvh, pbvh = tables.bvh, tables.pbvh
        if bvh is not None:
            bvh = refit_bvh(bvh, v0, v1, v2)
            pbvh = traverse.build_streams(bvh, max_tris=pbvh.cut_tris).to(device)
        em_tri = tables.em_tri.cpu().numpy()
        ebvh = tables.ebvh
        if tables.num_emissive_tris > 0:
            ebvh = refit_bvh(ebvh, v0[em_tri], v1[em_tri], v2[em_tri])
        return dataclasses.replace(
            tables,
            v0=vcomp(v0), v1=vcomp(v1), v2=vcomp(v2),
            n0=vcomp(tri_n[:, 0]), n1=vcomp(tri_n[:, 1]), n2=vcomp(tri_n[:, 2]),
            tg0=vcomp(tri_tg[:, 0]), tg1=vcomp(tri_tg[:, 1]), tg2=vcomp(tri_tg[:, 2]),
            em_v0=vcomp(v0[em_tri]), em_v1=vcomp(v1[em_tri]), em_v2=vcomp(v2[em_tri]),
            bvh=bvh, pbvh=pbvh, ebvh=ebvh,
        )

    def _refit_instanced(self, tables: SceneTables) -> SceneTables:
        """O(instances) refit: new transforms, world AABBs and emissive
        world rows (scenegraph.py:737-794); the BLAS streams and the dense
        prototypes' tables are reused."""
        inst = tables.inst
        t, vcomp = _uploaders(tables.device)
        instances = list(self._iter_instances())
        if len(instances) != inst.num_instances:
            raise ValueError("refit requires unchanged topology; use upload()")
        proto_idx, _protos, tri_off, proto_aabb, num_proto_tris = self._proto_registry(instances)
        if num_proto_tris != inst.num_proto_tris:
            raise ValueError("refit requires unchanged topology; use upload()")
        (
            inv_rows, nrm_rows, inst_bmin, inst_bmax, members,
            _em_h, _em_tri_ids, em_w,
        ) = self._instance_pass(instances, proto_idx, tri_off, proto_aabb, num_proto_tris)

        groups = []
        for p, g in enumerate(inst.groups):
            gl = np.array(members[p], np.int32)
            groups.append(dataclasses.replace(
                g, inv=t(inv_rows[gl]), aabb_min=t(inst_bmin[gl]), aabb_max=t(inst_bmax[gl])))
        new_inst = dataclasses.replace(
            inst, groups=tuple(groups), inv_flat=t(inv_rows.T), nrm_flat=t(nrm_rows.T),
            box=t(union_box(inst_bmin, inst_bmax)))

        if tables.num_emissive_tris == 0:
            return dataclasses.replace(tables, inst=new_inst)
        ev0, ev1, ev2, en = (np.concatenate([r[k] for r in em_w]).astype(np.float32)
                             for k in range(4))
        # the CDF and the areas are not recomputed (the reference's update())
        return dataclasses.replace(
            tables,
            inst=new_inst,
            em_v0=vcomp(ev0), em_v1=vcomp(ev1), em_v2=vcomp(ev2),
            em_tables=dataclasses.replace(
                tables.em_tables, n0=t(en[:, 0]), n1=t(en[:, 1]), n2=t(en[:, 2])),
            ebvh=refit_bvh(tables.ebvh, ev0, ev1, ev2),
        )


def _uploaders(device):
    """(t, vcomp): a NumPy array to a tensor on ``device``, and a (K, 3)
    array to a V3 of (K,) columns there."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    def vcomp(a):
        a = np.asarray(a, np.float32)
        return V3(t(a[:, 0]), t(a[:, 1]), t(a[:, 2]))

    return t, vcomp
