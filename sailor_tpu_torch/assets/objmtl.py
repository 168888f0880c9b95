"""Wavefront OBJ + MTL importer (counterpart of sailor_tpu/assets/objmtl.py)
— ModelImporter parity for the reference's
Sponza-class content (`Content/Models/Sponza/sponza.obj` + `sponza.mtl`).

Same soup/table contract as assets/gltf.load_merged so scenes built from
either format flow through the identical Geometry/MaterialTable path.
The reference imports OBJ through assimp inside ModelImporter.cpp; here the
subset the shipped content uses is parsed directly: v/vt/vn, polygon faces
(fan-triangulated), usemtl groups, and the PBR-adjacent MTL fields the
Sponza library carries (Kd/Ks/Ke/Ns/d + map_Kd/map_bump/map_Ns/map_Ks/map_d).

MTL -> MaterialTable mapping (matches how the reference's generated .mat
files consume the same library — Content/Models/Sponza/materials/*.mat):
  Kd / map_Kd        -> albedo factor / albedo_texture
  map_bump|bump      -> normal_texture (tangent-space)
  Ns                 -> roughness = sqrt(2 / (Ns + 2)) (Blinn-Phong fold)
  map_Ns             -> roughness map   \\  folded into ONE synthesized
  map_Ks (metallic)  -> metallic map    /  ORM image (G=rough, B=metal)
  map_d              -> alpha mask -> albedo texture alpha + Masked queue
  Ke                 -> emissive
  d / Tr             -> opacity (Transparent queue when < 1)
"""

from __future__ import annotations

import os

import numpy as np


def _resolve_tex(base_dir: str, rel: str) -> str | None:
    """Find a texture file, tolerating extension AND case drift (the
    Sponza MTL names lowercase .dds files; the vendored content ships
    mixed-case .png)."""
    rel = rel.replace("\\", "/").strip()
    cand = os.path.join(base_dir, rel)
    if os.path.exists(cand):
        return cand
    stem = os.path.splitext(cand)[0]
    exts = (".png", ".jpg", ".jpeg", ".tga", ".bmp")
    for ext in exts:
        if os.path.exists(stem + ext):
            return stem + ext
    d = os.path.dirname(cand)
    want = os.path.splitext(os.path.basename(cand))[0].lower()
    if os.path.isdir(d):
        for f in os.listdir(d):
            fs, fe = os.path.splitext(f)
            if fs.lower() == want and fe.lower() in exts:
                return os.path.join(d, f)
    return None


def _decode(path: str) -> np.ndarray:
    """Decode to float32 linear RGBA (sRGB decode matches gltf.py) through
    the port's decoders (``textures.imread``: PNG, BMP, TGA, HDR; the
    other formats raise)."""
    from sailor_tpu_torch.assets.textures import imread

    arr = np.asarray(imread(path)).astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.full_like(arr[..., :1], 255.0)], -1)
    arr = arr / 255.0
    rgb = arr[..., :3]
    arr[..., :3] = np.where(
        rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4
    )
    return arr


def load_mtl(path: str):
    """Parse an MTL library. Returns (table dict — gltf.materials() schema,
    images list, name -> material index)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    mats: list[dict] = []
    cur: dict | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = {"name": tok[1] if len(tok) > 1 else f"m{len(mats)}"}
                mats.append(cur)
            elif cur is None:
                continue
            elif key in ("Kd", "Ke", "Ks"):
                cur[key] = [float(x) for x in tok[1:4]]
            elif key in ("Ns", "d", "Tr", "Ni"):
                cur[key] = float(tok[1])
            elif key in ("map_Kd", "map_bump", "bump", "map_Ns", "map_Ks",
                         "map_d"):
                cur["map_bump" if key == "bump" else key] = " ".join(tok[1:])

    n = max(len(mats), 1)
    table = {
        "albedo": np.ones((n, 3), np.float32) * 0.8,
        "metallic": np.zeros(n, np.float32),
        "roughness": np.full(n, 0.6, np.float32),
        "emissive": np.zeros((n, 3), np.float32),
        "albedo_texture": np.full(n, -1, np.int32),
        "normal_texture": np.full(n, -1, np.int32),
        "orm_texture": np.full(n, -1, np.int32),
        "emissive_texture": np.full(n, -1, np.int32),
        "queue": np.zeros(n, np.int32),
        "alpha_cutoff": np.full(n, 0.5, np.float32),
        "opacity": np.ones(n, np.float32),
        "transmission": np.zeros(n, np.float32),
        "ior": np.full(n, 1.5, np.float32),
        "atten_color": np.ones((n, 3), np.float32),
        "atten_dist": np.zeros(n, np.float32),
    }
    images: list[np.ndarray] = []
    cache: dict[str, int] = {}

    def image_of(p: str | None) -> int:
        if p is None:
            return -1
        if p not in cache:
            cache[p] = len(images)
            images.append(_decode(p))
        return cache[p]

    names: dict[str, int] = {}
    for i, m in enumerate(mats):
        names[m["name"]] = i
        table["albedo"][i] = m.get("Kd", [0.8, 0.8, 0.8])
        table["emissive"][i] = m.get("Ke", [0, 0, 0])
        ns = float(m.get("Ns", 10.0))
        table["roughness"][i] = np.sqrt(2.0 / (ns + 2.0))
        d = float(m.get("d", 1.0)) * (1.0 - float(m.get("Tr", 0.0)))
        if d < 1.0:
            table["queue"][i] = 2
            table["opacity"][i] = d
        table["ior"][i] = float(m.get("Ni", 1.5))

        alb = _resolve_tex(base_dir, m["map_Kd"]) if "map_Kd" in m else None
        mask = _resolve_tex(base_dir, m["map_d"]) if "map_d" in m else None
        if alb is not None:
            if mask is not None:
                # fold the alpha mask into the albedo texture's A channel
                # (the reference's Masked queue discards on it)
                a_img = _decode(alb)
                m_img = _decode(mask)
                if m_img.shape[:2] != a_img.shape[:2]:
                    ys = (np.linspace(0, m_img.shape[0] - 1, a_img.shape[0])
                          .astype(int))
                    xs = (np.linspace(0, m_img.shape[1] - 1, a_img.shape[1])
                          .astype(int))
                    m_img = m_img[ys][:, xs]
                a_img[..., 3] = m_img[..., :3].max(axis=-1)
                key = alb + "|" + mask
                if key not in cache:
                    cache[key] = len(images)
                    images.append(a_img)
                table["albedo_texture"][i] = cache[key]
                table["queue"][i] = 1  # Masked
            else:
                table["albedo_texture"][i] = image_of(alb)
        nrm = (_resolve_tex(base_dir, m["map_bump"])
               if "map_bump" in m else None)
        table["normal_texture"][i] = image_of(nrm)

        rough_p = _resolve_tex(base_dir, m["map_Ns"]) if "map_Ns" in m else None
        metal_p = _resolve_tex(base_dir, m["map_Ks"]) if "map_Ks" in m else None
        if rough_p is not None or metal_p is not None:
            # synthesize one glTF-convention ORM image: G=rough, B=metal
            key = f"ORM|{rough_p}|{metal_p}"
            if key not in cache:
                r_img = _decode(rough_p) if rough_p else None
                m_img = _decode(metal_p) if metal_p else None
                ref = r_img if r_img is not None else m_img
                h, w = ref.shape[:2]

                def fit(img, fill):
                    if img is None:
                        return np.full((h, w), fill, np.float32)
                    if img.shape[:2] != (h, w):
                        ys = np.linspace(0, img.shape[0] - 1, h).astype(int)
                        xs = np.linspace(0, img.shape[1] - 1, w).astype(int)
                        img = img[ys][:, xs]
                    return img[..., 0]

                orm = np.stack(
                    [np.ones((h, w), np.float32), fit(r_img, 1.0),
                     fit(m_img, 0.0), np.ones((h, w), np.float32)], -1,
                )
                cache[key] = len(images)
                images.append(orm)
            table["orm_texture"][i] = cache[key]
            # map multiplies the factor — neutral factors when mapped
            if rough_p is not None:
                table["roughness"][i] = 1.0
            if metal_p is not None:
                table["metallic"][i] = 1.0
    return table, images, names


def load_merged(path: str):
    """Load an OBJ (+ its mtllib) into (soup dict, material table, images).

    Same soup schema as gltf.load_merged; vertices are deduped on their
    full v/vt/vn index triple, polygon faces fan-triangulate, and missing
    normals accumulate area-weighted face normals.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    vs: list[list[float]] = []
    vts: list[list[float]] = []
    vns: list[list[float]] = []
    faces: list[tuple] = []      # (corner triplets, material id)
    table = images = None
    names: dict[str, int] = {}
    cur_mat = 0

    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif key == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif key == "mtllib":
                mp = os.path.join(base_dir, " ".join(tok[1:]))
                if os.path.exists(mp):
                    table, images, names = load_mtl(mp)
            elif key == "usemtl":
                cur_mat = names.get(" ".join(tok[1:]), 0)
            elif key == "f":
                corners = []
                for c in tok[1:]:
                    p = (c.split("/") + ["", ""])[:3]
                    vi = int(p[0])
                    ti = int(p[1]) if p[1] else 0
                    ni = int(p[2]) if p[2] else 0
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    faces.append(
                        ((corners[0], corners[k], corners[k + 1]), cur_mat)
                    )

    if table is None:
        table, images = load_mtl_defaults(), []

    nv, nt, nn = len(vs), len(vts), len(vns)

    def absi(i, n):
        return i - 1 if i > 0 else (n + i if i < 0 else -1)

    vert_key: dict[tuple, int] = {}
    pos_l, uv_l, nrm_l = [], [], []
    idx = np.zeros((len(faces), 3), np.int32)
    mat = np.zeros(len(faces), np.int32)
    have_n = np.zeros(0, bool)
    have_flags = []
    for fi, (corners, mid) in enumerate(faces):
        mat[fi] = mid
        for ci, (vi, ti, ni) in enumerate(corners):
            kk = (vi, ti, ni)
            j = vert_key.get(kk)
            if j is None:
                j = len(pos_l)
                vert_key[kk] = j
                pos_l.append(vs[absi(vi, nv)])
                uv_l.append(vts[absi(ti, nt)] if ti else [0.0, 0.0])
                nrm_l.append(vns[absi(ni, nn)] if ni else [0.0, 0.0, 0.0])
                have_flags.append(bool(ni))
            idx[fi, ci] = j

    pos = np.asarray(pos_l, np.float32).reshape(-1, 3)
    uv = np.asarray(uv_l, np.float32).reshape(-1, 2)
    # OBJ vt origin is bottom-left; the engine samples top-left (gltf)
    uv[:, 1] = 1.0 - uv[:, 1]
    nrm = np.asarray(nrm_l, np.float32).reshape(-1, 3)
    have_n = np.asarray(have_flags, bool)
    if not have_n.all() and len(idx):
        e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
        e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
        fn = np.cross(e1, e2)
        acc = np.zeros_like(pos)
        for k in range(3):
            np.add.at(acc, idx[:, k], fn)
        acc /= np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-12)
        nrm[~have_n] = acc[~have_n]
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)

    soup = {
        "position": pos,
        "normal": nrm,
        "uv": uv,
        "color": np.ones((len(pos), 4), np.float32),
        "indices": idx,
        "material_id": mat,
    }
    return soup, table, images


def load_mtl_defaults():
    """One default material row (OBJ with no mtllib)."""
    return {
        "albedo": np.full((1, 3), 0.8, np.float32),
        "metallic": np.zeros(1, np.float32),
        "roughness": np.full(1, 0.6, np.float32),
        "emissive": np.zeros((1, 3), np.float32),
        "albedo_texture": np.full(1, -1, np.int32),
        "normal_texture": np.full(1, -1, np.int32),
        "orm_texture": np.full(1, -1, np.int32),
        "emissive_texture": np.full(1, -1, np.int32),
        "queue": np.zeros(1, np.int32),
        "alpha_cutoff": np.full(1, 0.5, np.float32),
        "opacity": np.ones(1, np.float32),
        "transmission": np.zeros(1, np.float32),
        "ior": np.full(1, 1.5, np.float32),
        "atten_color": np.ones((1, 3), np.float32),
        "atten_dist": np.zeros(1, np.float32),
    }
