"""Minimal self-contained glTF 2.0 parser (JSON + binary buffers).

Port of ``vulkan_raytracer_tpu/scene/gltf.py`` (NumPy-only, so the code is
the same; its accessors and transforms are bit-equal to the JAX package's).

Replaces the reference's vendored tinygltf (scene.cpp:23-143 uses
tinygltf::LoadASCIIFromFile).  Supports what the renderer consumes:

* .gltf (JSON) and .glb (binary container) files;
* buffers from base64 data URIs or external files;
* accessors with byteStride (interleaved), normalized integer attributes,
  all index component types (u8/u16/u32 — scene.cpp:118-137);
* meshes/primitives (TRIANGLES), nodes (matrix or TRS), scenes;
* materials incl. the five KHR extensions the reference handles
  (emissive_strength / transmission / volume / anisotropy / dispersion,
  scene.cpp:182-231);
* KHR_lights_punctual point/directional lights (scene.cpp:246-270).

Returns plain Python/NumPy structures; the scene graph layer
(:mod:`vulkan_raytracer_tpu_torch.scene.scenegraph`) interprets them.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_NUM_COMPONENTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GLTFError(RuntimeError):
    pass


def _load_buffers(doc: dict, base_dir: Path, glb_bin: bytes | None) -> list[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise GLTFError("buffer without uri outside a GLB container")
            out.append(glb_bin[: buf["byteLength"]])
        elif uri.startswith("data:"):
            _, b64 = uri.split(",", 1)
            out.append(base64.b64decode(b64))
        else:
            out.append((base_dir / uri).read_bytes())
    return out


class GLTF:
    """Parsed glTF document with accessor decoding."""

    def __init__(self, doc: dict, buffers: list[bytes], base_dir: Path):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @classmethod
    def load(cls, path: str | Path) -> "GLTF":
        path = Path(path)
        data = path.read_bytes()
        glb_bin = None
        if data[:4] == b"glTF":  # GLB container
            magic, version, length = struct.unpack_from("<4sII", data, 0)
            off = 12
            doc = None
            while off < length:
                clen, ctype = struct.unpack_from("<I4s", data, off)
                chunk = data[off + 8 : off + 8 + clen]
                if ctype == b"JSON":
                    doc = json.loads(chunk)
                elif ctype == b"BIN\x00":
                    glb_bin = chunk
                off += 8 + clen + (-clen % 4)
            if doc is None:
                raise GLTFError("GLB container missing JSON chunk")
        else:
            doc = json.loads(data)
        return cls(doc, _load_buffers(doc, path.parent, glb_bin), path.parent)

    # -- accessors -----------------------------------------------------

    def _read_view(self, view_idx, byte_offset, dtype, ncomp, count, stride_override=None):
        """Raw (count, ncomp) read from a bufferView with optional stride."""
        bv = self.doc["bufferViews"][view_idx]
        buf = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + byte_offset
        itemsize = np.dtype(dtype).itemsize
        elem_bytes = itemsize * ncomp
        stride = stride_override or bv.get("byteStride", elem_bytes) or elem_bytes
        if stride == elem_bytes:
            return np.frombuffer(buf, dtype, count * ncomp, start).reshape(count, ncomp)
        raw = np.frombuffer(buf, np.uint8)
        rows = np.arange(count)[:, None] * stride + start
        cols = np.arange(elem_bytes)[None, :]
        return raw[rows + cols].copy().view(dtype).reshape(count, ncomp)

    def accessor(self, idx: int) -> np.ndarray:
        """Decode accessor ``idx`` to an (count, ncomp) ndarray.

        Normalized integer attributes are converted to float per the glTF
        spec.  Sparse accessors are supported: the base (bufferView data or
        zeros) is patched with sparse indices/values (glTF 2.0 §3.6.2.3 —
        tinygltf does the equivalent in the reference's loader).
        """
        acc = self.doc["accessors"][idx]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        ncomp = _NUM_COMPONENTS[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            arr = np.zeros((count, ncomp), dtype)
        else:
            arr = self._read_view(
                acc["bufferView"], acc.get("byteOffset", 0), dtype, ncomp, count
            )
        arr = np.array(arr)  # writable copy
        if "sparse" in acc:
            sp = acc["sparse"]
            n_sp = sp["count"]
            sidx = sp["indices"]
            idx_dtype = _COMPONENT_DTYPE[sidx["componentType"]]
            indices = self._read_view(
                sidx["bufferView"], sidx.get("byteOffset", 0), idx_dtype, 1, n_sp
            ).reshape(-1).astype(np.int64)
            sval = sp["values"]
            values = self._read_view(
                sval["bufferView"], sval.get("byteOffset", 0), dtype, ncomp, n_sp
            )
            arr[indices] = values
        if acc.get("normalized", False) and dtype != np.float32:
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / float(info.max)
            if info.min < 0:
                arr = np.maximum(arr, -1.0)
        return arr

    # -- convenience views ----------------------------------------------

    @property
    def materials(self) -> list[dict]:
        return self.doc.get("materials", [])

    @property
    def meshes(self) -> list[dict]:
        return self.doc.get("meshes", [])

    @property
    def nodes(self) -> list[dict]:
        return self.doc.get("nodes", [])

    @property
    def images(self) -> list[dict]:
        return self.doc.get("images", [])

    @property
    def textures(self) -> list[dict]:
        return self.doc.get("textures", [])

    @property
    def lights(self) -> list[dict]:
        """KHR_lights_punctual light definitions (scene.cpp:246-270)."""
        return (
            self.doc.get("extensions", {})
            .get("KHR_lights_punctual", {})
            .get("lights", [])
        )

    def scene_root_nodes(self) -> list[int]:
        scenes = self.doc.get("scenes", [])
        if not scenes:
            return []
        scene_idx = self.doc.get("scene", 0)
        return scenes[scene_idx].get("nodes", [])

    def node_light(self, node: dict) -> int:
        return node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light", -1)

    def primitive_indices(self, prim: dict) -> np.ndarray:
        """Triangle indices as uint32, synthesised for non-indexed meshes."""
        if "indices" in prim:
            return self.accessor(prim["indices"]).reshape(-1).astype(np.uint32)
        n = self.doc["accessors"][prim["attributes"]["POSITION"]]["count"]
        return np.arange(n, dtype=np.uint32)


def node_local_transform(node: dict) -> np.ndarray:
    """Local transform: column-major ``matrix`` or T*R*S composition.

    Mirrors scene.cpp:355-365 — scale, then rotation, then translation,
    each left-multiplied.  Quaternion order in glTF is (x, y, z, w).
    """
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(map(np.float32, node["scale"])) + [np.float32(1)])
    if "rotation" in node:
        x, y, z, w = map(float, node["rotation"])
        m = quat_to_mat4(w, x, y, z) @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m.astype(np.float32)


def quat_to_mat4(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Unit quaternion -> rotation matrix (glm::mat4(quat) equivalent)."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n > 0:
        w, x, y, z = w / n, x / n, y / n, z / n
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return m
