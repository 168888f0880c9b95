"""Minimal binary-FBX importer (counterpart of sailor_tpu/assets/fbx.py) —
ModelImporter parity for the reference's
shipped FBX content (`Content/Models/Cerberus/cerberus.fbx` v7300,
`Content/Models/KnightArtorias/Artorias.fbx` v7400; the reference loads
them through assimp inside ModelImporter.cpp).

Scope: the subset those files use — the binary node tree (4-byte record
headers for version < 7500, 8-byte after), zlib-compressed typed arrays,
Geometry nodes (Vertices / PolygonVertexIndex / LayerElementNormal / UV /
Material), per-polygon material assignment, Model transforms connected to
their geometry, and Material/Texture objects with relative filenames.
Returns the same (soup, table, images) contract as assets/objmtl.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _read_node(buf, pos, long_offsets: bool):
    """Parse one node record; returns (node dict | None, next_pos)."""
    if long_offsets:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    nlen = buf[pos]
    pos += 1
    if end == 0:  # null record terminates a sibling list
        return None, pos
    name = buf[pos:pos + nlen].decode("ascii", "replace")
    pos += nlen
    props = []
    for _ in range(nprops):
        t = chr(buf[pos]); pos += 1
        if t in "YCIFDL":
            fmt = {"Y": "<h", "C": "<b", "I": "<i", "F": "<f",
                   "D": "<d", "L": "<q"}[t]
            (v,) = struct.unpack_from(fmt, buf, pos)
            pos += struct.calcsize(fmt)
            props.append(bool(v) if t == "C" else v)
        elif t in "fdlib":
            n, enc, clen = struct.unpack_from("<III", buf, pos)
            pos += 12
            dt = {"f": np.float32, "d": np.float64, "l": np.int64,
                  "i": np.int32, "b": np.int8}[t]
            if enc:
                raw = zlib.decompress(buf[pos:pos + clen])
                pos += clen
            else:
                raw = bytes(buf[pos:pos + n * np.dtype(dt).itemsize])
                pos += n * np.dtype(dt).itemsize
            props.append(np.frombuffer(raw, dt))
        elif t == "S":
            (n,) = struct.unpack_from("<I", buf, pos); pos += 4
            props.append(buf[pos:pos + n].decode("utf-8", "replace"))
            pos += n
        elif t == "R":
            (n,) = struct.unpack_from("<I", buf, pos); pos += 4
            props.append(bytes(buf[pos:pos + n]))
            pos += n
        else:
            raise ValueError(f"unknown FBX property type {t!r}")
    children = []
    while pos < end:
        child, pos = _read_node(buf, pos, long_offsets)
        if child is None:
            break
        children.append(child)
    return {"name": name, "props": props, "children": children}, max(pos, end)


def parse(path: str):
    """Parse a binary FBX into (version, top-level node list)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:21] != b"Kaydara FBX Binary  \x00":
        raise ValueError("not a binary FBX file")
    (version,) = struct.unpack_from("<I", buf, 23)
    long_offsets = version >= 7500
    pos = 27
    nodes = []
    while pos < len(buf):
        node, pos = _read_node(buf, pos, long_offsets)
        if node is None:
            break
        nodes.append(node)
    return version, nodes


def _find(nodes, name):
    return [n for n in nodes if n["name"] == name]


def _child(node, name):
    for c in node["children"]:
        if c["name"] == name:
            return c
    return None


def _prop70(node, key, default=None):
    p70 = _child(node, "Properties70")
    if p70 is None:
        return default
    for p in p70["children"]:
        if p["props"] and p["props"][0] == key:
            vals = p["props"][4:]
            return vals if len(vals) > 1 else (vals[0] if vals else default)
    return default


def _layer_values(geom, layer_name, value_name, index_name, n_corners,
                  poly_vert, width):
    """Expand a LayerElement to per-CORNER values (n_corners, width)."""
    lay = _child(geom, layer_name)
    if lay is None:
        return None
    mapping = (_child(lay, "MappingInformationType") or {"props": [""]})["props"][0]
    ref = (_child(lay, "ReferenceInformationType") or {"props": ["Direct"]})["props"][0]
    vals_node = _child(lay, value_name)
    if vals_node is None:
        return None
    vals = np.asarray(vals_node["props"][0], np.float64).reshape(-1, width)
    if ref == "IndexToDirect":
        idx_node = _child(lay, index_name)
        if idx_node is not None and len(idx_node["props"]):
            vals = vals[np.asarray(idx_node["props"][0], np.int64)]
    if mapping == "ByPolygonVertex":
        return vals[:n_corners]
    if mapping == "ByVertice" or mapping == "ByVertex":
        return vals[poly_vert]
    if mapping == "AllSame":
        return np.broadcast_to(vals[0], (n_corners, width))
    return None


def _model_matrix(model):
    """Lcl Translation/Rotation/Scaling -> 4x4 (XYZ euler, degrees)."""
    t = _prop70(model, "Lcl Translation", (0.0, 0.0, 0.0)) or (0, 0, 0)
    r = _prop70(model, "Lcl Rotation", (0.0, 0.0, 0.0)) or (0, 0, 0)
    s = _prop70(model, "Lcl Scaling", (1.0, 1.0, 1.0)) or (1, 1, 1)
    rx, ry, rz = [np.deg2rad(float(a)) for a in r]

    def rot(axis, a):
        c, sn = np.cos(a), np.sin(a)
        m = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c; m[j, j] = c
        m[i, j] = -sn if axis != 1 else sn
        m[j, i] = sn if axis != 1 else -sn
        return m

    rm = rot(2, rz) @ rot(1, ry) @ rot(0, rx)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (rm * np.asarray(s, np.float64)[None, :]).astype(np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def load_merged(path: str, scale: float = 0.01):
    """Load a binary FBX into (soup, material table, images).

    ``scale``: FBX content is commonly authored in centimeters; the
    engine's unit is meters (matches the reference's import scaling).
    """
    from sailor_tpu_torch.assets.objmtl import _decode, load_mtl_defaults

    base_dir = os.path.dirname(os.path.abspath(path))
    _version, top = parse(path)
    objects = _find(top, "Objects")[0]
    conns = _find(top, "Connections")
    edges = []
    if conns:
        for c in conns[0]["children"]:
            p = c["props"]
            # (kind, child_id, parent_id[, property])
            edges.append((p[1], p[2], p[3] if len(p) > 3 else None))

    by_id = {}
    for o in objects["children"]:
        if o["props"] and isinstance(o["props"][0], (int, np.integer)):
            by_id[int(o["props"][0])] = o

    def parents_of(cid):
        return [(pid, prop) for (c, pid, prop) in edges if c == cid]

    def children_of(pid):
        return [(cid, prop) for (cid, p, prop) in edges if p == pid]

    # ---- materials + textures -------------------------------------------
    mat_nodes = [o for o in objects["children"] if o["name"] == "Material"]
    table = load_mtl_defaults()
    n = max(len(mat_nodes), 1)
    for k, v in table.items():
        table[k] = np.repeat(v, n, axis=0) if v.ndim > 1 else np.repeat(v, n)
    images, cache = [], {}

    def image_of(rel):
        rel = rel.replace("\\", "/")
        cand = os.path.join(base_dir, rel)
        if not os.path.exists(cand):
            cand2 = os.path.join(base_dir, "textures", os.path.basename(rel))
            cand = cand2 if os.path.exists(cand2) else None
        if cand is None:
            return -1
        if cand not in cache:
            cache[cand] = len(images)
            images.append(_decode(cand))
        return cache[cand]

    def textures_by_name(mat_name: str):
        """Name-convention fallback: the shipped FBX content carries NO
        Texture objects — its textures pair with materials by filename
        (Mat_Chainmail -> Mat_Chainmail_Base_Color.png; Mat_Sword ->
        Sword_albedo.jpg), the same pairing the reference's generated
        .mat files encode."""
        tdir = os.path.join(base_dir, "textures")
        if not os.path.isdir(tdir):
            return {}
        files = {f.lower(): f for f in os.listdir(tdir)}
        stems = [mat_name, mat_name.removeprefix("Mat_")]
        kinds = {
            "albedo": ("_base_color", "_basecolor", "_albedo", "_diffuse"),
            "normal": ("_normal_opengl", "_normal", "_bump"),
            "roughness": ("_roughness",),
            "metallic": ("_metallic", "_metalness"),
        }
        out = {}
        for kind, sufs in kinds.items():
            for stem in stems:
                for suf in sufs:
                    for ext in (".png", ".jpg", ".jpeg", ".tga"):
                        f = files.get((stem + suf + ext).lower())
                        if f is not None:
                            out[kind] = os.path.join("textures", f)
                            break
                    if kind in out:
                        break
                if kind in out:
                    break
        return out

    mat_index = {}
    for i, m in enumerate(mat_nodes):
        mat_index[int(m["props"][0])] = i
        dc = _prop70(m, "DiffuseColor", (0.8, 0.8, 0.8))
        table["albedo"][i] = [float(x) for x in dc][:3]
        sh = _prop70(m, "Shininess", 20.0)
        table["roughness"][i] = float(np.sqrt(2.0 / (float(sh) + 2.0)))
        mat_name = str(m["props"][1]).split("\x00")[0] if len(m["props"]) > 1 else ""
        named = textures_by_name(mat_name)
        if "albedo" in named:
            table["albedo_texture"][i] = image_of(named["albedo"])
            table["albedo"][i] = [1.0, 1.0, 1.0]
        if "normal" in named:
            table["normal_texture"][i] = image_of(named["normal"])
        if "roughness" in named or "metallic" in named:
            # synthesize a glTF-convention ORM image (G=rough, B=metal)
            r_im = (_decode(os.path.join(base_dir, named["roughness"]))
                    if "roughness" in named else None)
            m_im = (_decode(os.path.join(base_dir, named["metallic"]))
                    if "metallic" in named else None)
            ref = r_im if r_im is not None else m_im
            h, w = ref.shape[:2]

            def fit(img, fill):
                if img is None:
                    return np.full((h, w), fill, np.float32)
                if img.shape[:2] != (h, w):
                    ys = np.linspace(0, img.shape[0] - 1, h).astype(int)
                    xs = np.linspace(0, img.shape[1] - 1, w).astype(int)
                    img = img[ys][:, xs]
                return img[..., 0]

            key = f"ORM|{named.get('roughness')}|{named.get('metallic')}"
            if key not in cache:
                cache[key] = len(images)
                images.append(np.stack(
                    [np.ones((h, w), np.float32), fit(r_im, 1.0),
                     fit(m_im, 0.0), np.ones((h, w), np.float32)], -1))
            table["orm_texture"][i] = cache[key]
            if "roughness" in named:
                table["roughness"][i] = 1.0
            if "metallic" in named:
                table["metallic"][i] = 1.0
        # textures connected to this material (by property name)
        for tid, prop in children_of(int(m["props"][0])):
            t = by_id.get(tid)
            if t is None or t["name"] != "Texture":
                continue
            fn = _child(t, "RelativeFilename") or _child(t, "FileName")
            if fn is None or not fn["props"]:
                continue
            layer = image_of(str(fn["props"][0]))
            if layer < 0:
                continue
            key = (prop or "DiffuseColor").lower()
            if "diffuse" in key or "base" in key:
                table["albedo_texture"][i] = layer
                table["albedo"][i] = [1.0, 1.0, 1.0]
            elif "normal" in key or "bump" in key:
                table["normal_texture"][i] = layer
            elif "specular" in key or "reflection" in key:
                table["orm_texture"][i] = layer

    # ---- geometry --------------------------------------------------------
    pos_l, nrm_l, uv_l, idx_l, mat_l = [], [], [], [], []
    voff = 0
    for geom in (o for o in objects["children"] if o["name"] == "Geometry"):
        vtx = _child(geom, "Vertices")
        pvi = _child(geom, "PolygonVertexIndex")
        if vtx is None or pvi is None:
            continue
        verts = np.asarray(vtx["props"][0], np.float64).reshape(-1, 3)
        raw_idx = np.asarray(pvi["props"][0], np.int64)
        corner_v = np.where(raw_idx < 0, -raw_idx - 1, raw_idx)
        n_corners = len(corner_v)

        nrm = _layer_values(geom, "LayerElementNormal", "Normals",
                            "NormalsIndex", n_corners, corner_v, 3)
        uv = _layer_values(geom, "LayerElementUV", "UV", "UVIndex",
                           n_corners, corner_v, 2)
        # per-polygon material layer
        mat_lay = _child(geom, "LayerElementMaterial")
        poly_mat = None
        if mat_lay is not None:
            mnode = _child(mat_lay, "Materials")
            if mnode is not None and len(mnode["props"]):
                poly_mat = np.asarray(mnode["props"][0], np.int64)

        # model transform via connections (geometry -> model)
        gid = int(geom["props"][0])
        mtx = np.eye(4, dtype=np.float32)
        for pid, _ in parents_of(gid):
            pm = by_id.get(pid)
            if pm is not None and pm["name"] == "Model":
                mtx = _model_matrix(pm)
                break

        # material ids of THIS geometry's connected materials, in
        # connection order (FBX material layer indexes that order)
        local_mats = []
        for pid, _ in parents_of(gid):
            pm = by_id.get(pid)
            if pm is None or pm["name"] != "Model":
                continue
            for cid, _ in children_of(pid):
                cn = by_id.get(cid)
                if cn is not None and cn["name"] == "Material":
                    local_mats.append(mat_index[int(cn["props"][0])])

        # fan-triangulate polygons (negative index closes a polygon)
        tris, tri_poly = [], []
        start = 0
        poly = 0
        for k in range(n_corners):
            if raw_idx[k] < 0:
                for j in range(start + 1, k):
                    tris.append((start, j, j + 1))
                    tri_poly.append(poly)
                start = k + 1
                poly += 1
        tris = np.asarray(tris, np.int64)
        tri_poly = np.asarray(tri_poly, np.int64)
        if len(tris) == 0:
            continue

        p = (verts[corner_v] @ mtx[:3, :3].T + mtx[:3, 3]) * scale
        pos_l.append(p.astype(np.float32))
        if nrm is not None:
            nw = np.asarray(nrm, np.float64) @ np.linalg.inv(
                mtx[:3, :3].astype(np.float64)
            )
            nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
            nrm_l.append(nw.astype(np.float32))
        else:
            nrm_l.append(np.zeros((n_corners, 3), np.float32))
        if uv is not None:
            u = np.asarray(uv, np.float32)
            u[:, 1] = 1.0 - u[:, 1]   # FBX UV origin is bottom-left
            uv_l.append(u)
        else:
            uv_l.append(np.zeros((n_corners, 2), np.float32))
        idx_l.append(tris + voff)
        if poly_mat is not None and len(local_mats):
            lm = np.asarray(local_mats + [0], np.int64)
            if len(poly_mat) == 1:      # AllSame mapping
                pm = np.full(len(tri_poly), poly_mat[0], np.int64)
            else:                       # ByPolygon
                pm = poly_mat[np.clip(tri_poly, 0, len(poly_mat) - 1)]
            pm = np.clip(pm, 0, len(local_mats) - 1)
            mat_l.append(lm[pm].astype(np.int32))
        else:
            mat_l.append(np.full(len(tris),
                                 local_mats[0] if local_mats else 0,
                                 np.int32))
        voff += n_corners

    pos = np.concatenate(pos_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    idx = np.concatenate(idx_l).astype(np.int32)
    # generate flat normals where the layer was missing (all-zero rows)
    missing = (np.abs(nrm).sum(-1) == 0)
    if missing.any():
        e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
        e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
        fn = np.cross(e1, e2)
        acc = np.zeros_like(pos)
        for k in range(3):
            np.add.at(acc, idx[:, k], fn)
        acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
        nrm[missing] = acc[missing]

    soup = {
        "position": pos,
        "normal": nrm,
        "uv": np.concatenate(uv_l).astype(np.float32),
        "color": np.ones((len(pos), 4), np.float32),
        "indices": idx,
        "material_id": np.concatenate(mat_l),
    }
    return soup, table, images
