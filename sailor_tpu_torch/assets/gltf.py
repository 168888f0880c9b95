"""Minimal GLTF 2.0 / GLB importer (host, numpy; counterpart of
sailor_tpu/assets/gltf.py, Runtime/AssetRegistry/Model/ModelImporter.cpp).

Parses .gltf (JSON + external/base64 buffers) and .glb (binary container),
flattens the default scene's node hierarchy into a merged triangle soup
with world transforms applied, and extracts pbrMetallicRoughness materials
(+ optionally their textures). The reference decodes the images with
imageio; the port with ``textures.decode_bytes`` (PNG, JPEG, GIF, BMP,
TGA and Radiance HDR, sniffed or by the image's ``mimeType``; OpenEXR
raises NotImplementedError naming it).
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTF:
    def __init__(self, doc: dict, buffers: list[bytes], base_dir: str = "."):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    # -- container parsing ---------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "GLTF":
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return cls._parse_glb(data, base_dir)
        doc = json.loads(data.decode("utf-8"))
        return cls(doc, cls._load_buffers(doc, base_dir), base_dir)

    @classmethod
    def _parse_glb(cls, data: bytes, base_dir: str) -> "GLTF":
        magic, version, length = struct.unpack_from("<4sII", data, 0)
        assert magic == b"glTF" and version == 2, "unsupported GLB"
        off = 12
        doc = None
        bin_chunk = b""
        while off < length:
            clen, ctype = struct.unpack_from("<II", data, off)
            payload = data[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # 'JSON'
                doc = json.loads(payload.decode("utf-8"))
            elif ctype == 0x004E4942:  # 'BIN'
                bin_chunk = payload
            off += 8 + clen
        assert doc is not None, "GLB without JSON chunk"
        buffers = []
        for b in doc.get("buffers", []):
            uri = b.get("uri")
            if uri is None:
                buffers.append(bin_chunk)
            else:
                buffers.append(cls._load_uri(uri, base_dir))
        return cls(doc, buffers, base_dir)

    @staticmethod
    def _load_uri(uri: str, base_dir: str) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(base_dir, uri), "rb") as f:
            return f.read()

    @classmethod
    def _load_buffers(cls, doc: dict, base_dir: str) -> list[bytes]:
        return [cls._load_uri(b["uri"], base_dir) for b in doc.get("buffers", [])]

    # -- accessors -------------------------------------------------------------

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.doc["accessors"][idx]
        n = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize * ncomp
        if "bufferView" not in acc:
            out = np.zeros((n, ncomp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv.get("buffer", 0)]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride") or itemsize
            if stride == itemsize:
                out = np.frombuffer(
                    buf, dtype, count=n * ncomp, offset=start
                ).reshape(n, ncomp)
            else:  # interleaved
                raw = np.frombuffer(
                    buf, np.uint8, count=stride * n - (stride - itemsize),
                    offset=start,
                )
                out = np.lib.stride_tricks.as_strided(
                    raw.view(dtype), (n, ncomp), (stride, np.dtype(dtype).itemsize)
                ).copy()
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / max(abs(info.min), info.max)
        return np.ascontiguousarray(out)

    # -- scene flattening ---------------------------------------------------------

    def _node_matrix(self, node: dict) -> np.ndarray:
        if "matrix" in node:
            return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in node:
            m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.eye(4, dtype=np.float32)
            r[:3, :3] = np.asarray(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ],
                np.float32,
            )
            m = r @ m
        if "translation" in node:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = node["translation"]
            m = t @ m
        return m

    def flatten(self):
        """Yield (primitive dict, world matrix) over the default scene."""
        scene = self.doc.get("scenes", [{}])[self.doc.get("scene", 0)]
        nodes = self.doc.get("nodes", [])
        stack = [(i, np.eye(4, dtype=np.float32)) for i in scene.get("nodes", [])]
        while stack:
            idx, parent_m = stack.pop()
            node = nodes[idx]
            m = parent_m @ self._node_matrix(node)
            if "mesh" in node:
                mesh = self.doc["meshes"][node["mesh"]]
                for prim in mesh.get("primitives", []):
                    yield prim, m
            for child in node.get("children", []):
                stack.append((child, m))

    # -- materials -------------------------------------------------------------------

    def materials(self):
        """Material table dict (albedo/metallic/roughness/emissive arrays)."""
        mats = self.doc.get("materials", [])
        n = max(len(mats), 1)
        table = {
            "albedo": np.ones((n, 3), np.float32) * 0.8,
            "metallic": np.zeros(n, np.float32),
            "roughness": np.full(n, 0.6, np.float32),
            "emissive": np.zeros((n, 3), np.float32),
            "albedo_texture": np.full(n, -1, np.int32),
            "normal_texture": np.full(n, -1, np.int32),
            # ORM (metallicRoughness: G=roughness, B=metallic) + emissive
            # maps — sampled at path-tracer hit points (MaterialUtils.h:23-80)
            "orm_texture": np.full(n, -1, np.int32),
            "emissive_texture": np.full(n, -1, np.int32),
            "queue": np.zeros(n, np.int32),
            "alpha_cutoff": np.full(n, 0.5, np.float32),
            "opacity": np.ones(n, np.float32),
            # transmission/volume extensions (KHR_materials_transmission,
            # _ior, _volume) — consumed by the path tracer's BTDF path
            "transmission": np.zeros(n, np.float32),
            "ior": np.full(n, 1.5, np.float32),
            "atten_color": np.ones((n, 3), np.float32),
            "atten_dist": np.zeros(n, np.float32),
        }
        alpha_modes = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}
        for i, m in enumerate(mats):
            ext = m.get("extensions", {}) or {}
            tr = ext.get("KHR_materials_transmission", {})
            table["transmission"][i] = tr.get("transmissionFactor", 0.0)
            table["ior"][i] = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
            vol = ext.get("KHR_materials_volume", {})
            table["atten_color"][i] = vol.get("attenuationColor", [1, 1, 1])
            table["atten_dist"][i] = vol.get("attenuationDistance", 0.0)
            pbr = m.get("pbrMetallicRoughness", {})
            base = pbr.get("baseColorFactor", [1, 1, 1, 1])
            table["albedo"][i] = base[:3]
            table["metallic"][i] = pbr.get("metallicFactor", 1.0)
            table["roughness"][i] = pbr.get("roughnessFactor", 1.0)
            table["emissive"][i] = m.get("emissiveFactor", [0, 0, 0])
            table["queue"][i] = alpha_modes.get(m.get("alphaMode", "OPAQUE"), 0)
            table["alpha_cutoff"][i] = m.get("alphaCutoff", 0.5)
            if table["queue"][i] == 2 and len(base) > 3:
                table["opacity"][i] = base[3]
            if "baseColorTexture" in pbr:
                table["albedo_texture"][i] = self._image_of(
                    pbr["baseColorTexture"]["index"]
                )
            if "normalTexture" in m:
                table["normal_texture"][i] = self._image_of(
                    m["normalTexture"]["index"]
                )
            if "metallicRoughnessTexture" in pbr:
                table["orm_texture"][i] = self._image_of(
                    pbr["metallicRoughnessTexture"]["index"]
                )
            if "emissiveTexture" in m:
                table["emissive_texture"][i] = self._image_of(
                    m["emissiveTexture"]["index"]
                )
        return table

    def _image_of(self, texture_index: int) -> int:
        """GLTF texture index -> image index (the stacked-texture layer)."""
        textures = self.doc.get("textures", [])
        if 0 <= texture_index < len(textures):
            return textures[texture_index].get("source", -1)
        return -1

    def load_texture_images(self):
        """Decode all images to float32 linear RGBA arrays."""
        from sailor_tpu_torch.assets.textures import decode_bytes, imread

        out = []
        for img in self.doc.get("images", []):
            if "bufferView" in img:
                bv = self.doc["bufferViews"][img["bufferView"]]
                buf = self.buffers[bv.get("buffer", 0)]
                raw = buf[bv.get("byteOffset", 0) : bv.get("byteOffset", 0) + bv["byteLength"]]
                arr = decode_bytes(bytes(raw), f"images[{len(out)}]", img.get("mimeType"))
            else:
                arr = imread(os.path.join(self.base_dir, img["uri"]))
            arr = np.asarray(arr)
            if arr.dtype == np.uint8:
                arr = (arr.astype(np.float32) / 255.0) ** 2.2  # sRGB -> linear
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, -1)
            if arr.shape[-1] == 3:
                arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
            out.append(arr.astype(np.float32))
        return out


def load_merged(path: str):
    """Load a GLTF/GLB into (soup dict, material table) — the ModelImporter
    entry point. Applies node world transforms; missing normals are
    generated flat; missing UVs/colors default."""
    g = GLTF.load(path)
    pos_l, nrm_l, uv_l, col_l, idx_l, mat_l = [], [], [], [], [], []
    voff = 0
    for prim, m in g.flatten():
        attrs = prim.get("attributes", {})
        if "POSITION" not in attrs:
            continue
        p = g.accessor(attrs["POSITION"]).astype(np.float32)
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int32)
        else:
            idx = np.arange(len(p), dtype=np.int32)
        tri = idx.reshape(-1, 3)
        if "NORMAL" in attrs:
            n = g.accessor(attrs["NORMAL"]).astype(np.float32)
        else:  # flat normals
            n = np.zeros_like(p)
            e1 = p[tri[:, 1]] - p[tri[:, 0]]
            e2 = p[tri[:, 2]] - p[tri[:, 0]]
            fn = np.cross(e1, e2)
            for k in range(3):
                np.add.at(n, tri[:, k], fn)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        uv = (
            g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            if "TEXCOORD_0" in attrs
            else np.zeros((len(p), 2), np.float32)
        )
        col = (
            g.accessor(attrs["COLOR_0"]).astype(np.float32)
            if "COLOR_0" in attrs
            else np.ones((len(p), 4), np.float32)
        )
        if col.shape[-1] == 3:
            col = np.concatenate([col, np.ones_like(col[..., :1])], -1)

        # apply world transform
        pw = p @ m[:3, :3].T + m[:3, 3]
        ninv = np.linalg.inv(m[:3, :3]).astype(np.float32)
        nw = n @ ninv
        nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)

        pos_l.append(pw.astype(np.float32))
        nrm_l.append(nw.astype(np.float32))
        uv_l.append(uv)
        col_l.append(col)
        idx_l.append(tri + voff)
        mat_l.append(np.full(len(tri), prim.get("material", 0), np.int32))
        voff += len(p)

    soup = {
        "position": np.concatenate(pos_l),
        "normal": np.concatenate(nrm_l),
        "uv": np.concatenate(uv_l),
        "color": np.concatenate(col_l),
        "indices": np.concatenate(idx_l),
        "material_id": np.concatenate(mat_l),
    }
    return soup, g.materials()
