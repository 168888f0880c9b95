"""Asset files the port's importer tests write themselves (numpy only; not
collected): PNGs of any colour type, bit depth and row filter, a binary
FBX 7.4 and glTF documents. Nothing here is downloaded."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    c = tag + data
    return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(cur: np.ndarray, prior: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    cur = cur.astype(np.int32)
    prior = prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:len(cur)]
    upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])[:len(cur)]
    pred = {0: 0, 1: left, 2: prior, 3: (left + prior) >> 1,
            4: _paeth(left, prior, upleft)}[ftype]
    return ((cur - pred) & 0xFF).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _scanlines(s: np.ndarray, nch: int, depth: int, filters) -> bytes:
    """Filtered scanlines of the (h, w, nch) samples ``s``; row y takes
    ``filters[y % len(filters)]``."""
    h, w = s.shape[:2]
    if depth < 8:
        bits = ((s[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
        rows = np.packbits(bits.reshape(h, w * depth), axis=1)
    elif depth == 8:
        rows = s.astype(np.uint8).reshape(h, w * nch)
    else:
        rows = s.astype(">u2").view(np.uint8).reshape(h, w * nch * 2)
    bpp = max(1, nch * depth // 8)
    prior = np.zeros(rows.shape[1], np.uint8)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        out.append(bytes([f]) + _filter_row(rows[y], prior, bpp, f).tobytes())
        prior = rows[y]
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, *, filters=(0,),
              palette=None, trns: bytes | None = None, interlace: int = 0,
              idat_chunks: int = 1) -> bytes:
    """Encode ``samples`` ((H, W) or (H, W, C) sample values as integers)
    as a PNG of colour type ``ctype`` and bit ``depth``. Row y takes filter
    ``filters[y % len(filters)]`` (of each Adam7 pass with ``interlace=1``,
    whose seven passes are written as the standard lays them out);
    ``palette`` (P, 3) uint8 writes PLTE, ``trns`` a raw tRNS chunk; the
    zlib stream is cut into ``idat_chunks`` IDAT chunks."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    nch = _CHANNELS[ctype]
    s = s.reshape(h, w, nch).astype(np.uint32)
    if interlace:
        raw = b"".join(_scanlines(s[y0::dy, x0::dx], nch, depth, filters)
                       for x0, y0, dx, dy in ADAM7 if x0 < w and y0 < h)
    else:
        raw = _scanlines(s, nch, depth, filters)
    z = zlib.compress(raw, 9)
    cut = max(1, -(-len(z) // idat_chunks))
    parts = [z[i:i + cut] for i in range(0, len(z), cut)]
    body = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    chunks = _chunk(b"IHDR", body)
    if palette is not None:
        chunks += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        chunks += _chunk(b"tRNS", trns)
    chunks += b"".join(_chunk(b"IDAT", p) for p in parts)
    return b"\x89PNG\r\n\x1a\n" + chunks + _chunk(b"IEND", b"")


def rgba_png(img_u8: np.ndarray, filters=(0, 1, 2, 3, 4)) -> bytes:
    """An (H, W, 3 | 4) uint8 image as an 8-bit RGB or RGBA PNG."""
    return png_bytes(img_u8, 2 if img_u8.shape[-1] == 3 else 6, 8, filters=filters)


# --- binary FBX ---------------------------------------------------------------


class FbxNode:
    """One FBX node record: a name, properties and children. Properties are
    Python ints (written as 'L' int64), floats ('D'), str ('S'), bytes
    ('R'), or ("I", v) / ("i", array) / ("d", array) / ("f", array) /
    ("zi", array) / ("zd", array) pairs (a leading z: zlib-compressed)."""

    def __init__(self, name: str, props=(), children=()):
        self.name, self.props, self.children = name, list(props), list(children)


def _fbx_prop(p) -> bytes:
    if isinstance(p, tuple):
        code, v = p
        if code == "I":
            return b"I" + struct.pack("<i", v)
        z = code.startswith("z")
        t = code[-1]
        raw = np.ascontiguousarray(v, {"i": "<i4", "d": "<f8", "f": "<f4", "l": "<i8"}[t])
        data = zlib.compress(raw.tobytes()) if z else raw.tobytes()
        return t.encode() + struct.pack("<III", raw.size, 1 if z else 0, len(data)) + data
    if isinstance(p, bool):
        return b"C" + struct.pack("<b", p)
    if isinstance(p, int):
        return b"L" + struct.pack("<q", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        b = p.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    return b"R" + struct.pack("<I", len(p)) + bytes(p)


def _fbx_node(node: FbxNode, offset: int, long_offsets: bool) -> bytes:
    head = 25 if long_offsets else 13
    props = b"".join(_fbx_prop(p) for p in node.props)
    name = node.name.encode()
    pos = offset + head + len(name) + len(props)
    kids = b""
    for c in node.children:
        b = _fbx_node(c, pos + len(kids), long_offsets)
        kids += b
    if node.children:
        kids += b"\x00" * head  # the null record that ends the children
    end = pos + len(kids)
    fmt = "<QQQ" if long_offsets else "<III"
    return struct.pack(fmt, end, len(node.props), len(props)) + bytes([len(name)]) + name \
        + props + kids


def fbx_bytes(nodes, version: int = 7400) -> bytes:
    """A binary FBX file of the top-level ``nodes``; 64-bit record offsets
    from version 7500 on."""
    long_offsets = version >= 7500
    out = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", version)
    for n in nodes:
        out += _fbx_node(n, len(out), long_offsets)
    return out + b"\x00" * (25 if long_offsets else 13)


def _p70(*entries):
    return FbxNode("Properties70", [], [FbxNode("P", [k, k, "", "A", *v]) for k, v in entries])


def fbx_scene(version: int = 7400) -> bytes:
    """Two quads under one Model (translated, rotated, scaled) and a
    triangle under another: Vertices zlib-compressed in the first
    geometry and raw in the second, normals ByPolygonVertex/Direct, UVs
    ByPolygonVertex/IndexToDirect, LayerElementMaterial ByPolygon (the
    second geometry AllSame), two Materials with Properties70, a Texture
    connected to the second material's DiffuseColor, and Connections."""
    verts = np.array([[0, 0, 0], [100, 0, 0], [100, 100, 0], [0, 100, 0],
                      [200, 0, 0], [300, 0, 0], [300, 100, 0], [200, 100, 0]], np.float64)
    pvi = np.array([0, 1, 2, -4, 4, 5, 6, -8], np.int32)
    nrm = np.tile([0.0, 0.0, 1.0], 8)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64).reshape(-1)
    uv_index = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)

    def layer(name, mapping, ref, *kids):
        return FbxNode(name, [("I", 0)], [FbxNode("MappingInformationType", [mapping]),
                                          FbxNode("ReferenceInformationType", [ref]), *kids])

    geo1 = FbxNode("Geometry", [1001, "Quads\x00\x01Geometry", "Mesh"], [
        FbxNode("Vertices", [("zd", verts.reshape(-1))]),
        FbxNode("PolygonVertexIndex", [("zi", pvi)]),
        layer("LayerElementNormal", "ByPolygonVertex", "Direct",
              FbxNode("Normals", [("d", nrm)])),
        layer("LayerElementUV", "ByPolygonVertex", "IndexToDirect",
              FbxNode("UV", [("d", uv)]), FbxNode("UVIndex", [("i", uv_index)])),
        layer("LayerElementMaterial", "ByPolygon", "IndexToDirect",
              FbxNode("Materials", [("i", np.array([0, 1], np.int32))]))])
    tri = np.array([[0, 0, 50], [50, 0, 50], [0, 50, 50]], np.float64)
    geo2 = FbxNode("Geometry", [1002, "Tri\x00\x01Geometry", "Mesh"], [
        FbxNode("Vertices", [("d", tri.reshape(-1))]),
        FbxNode("PolygonVertexIndex", [("i", np.array([0, 1, -3], np.int32))]),
        layer("LayerElementMaterial", "AllSame", "IndexToDirect",
              FbxNode("Materials", [("i", np.array([0], np.int32))]))])
    model1 = FbxNode("Model", [2001, "Quads\x00\x01Model", "Mesh"], [_p70(
        ("Lcl Translation", (10.0, 0.0, -5.0)), ("Lcl Rotation", (0.0, 30.0, 10.0)),
        ("Lcl Scaling", (1.0, 2.0, 1.0)))])
    model2 = FbxNode("Model", [2002, "Tri\x00\x01Model", "Mesh"], [_p70(
        ("Lcl Translation", (0.0, 5.0, 0.0)))])
    mat_a = FbxNode("Material", [3001, "Mat_Stone\x00\x01Material", ""], [_p70(
        ("DiffuseColor", (0.5, 0.4, 0.3)), ("Shininess", (40.0,)))])
    mat_b = FbxNode("Material", [3002, "Mat_Cloth\x00\x01Material", ""], [_p70(
        ("DiffuseColor", (0.2, 0.3, 0.9)), ("Shininess", (8.0,)))])
    tex = FbxNode("Texture", [4001, "Cloth\x00\x01Texture", ""],
                  [FbxNode("RelativeFilename", ["maps\\cloth.png"])])
    conns = FbxNode("Connections", [], [
        FbxNode("C", ["OO", 2001, 0]), FbxNode("C", ["OO", 2002, 0]),
        FbxNode("C", ["OO", 1001, 2001]), FbxNode("C", ["OO", 1002, 2002]),
        FbxNode("C", ["OO", 3001, 2001]), FbxNode("C", ["OO", 3002, 2001]),
        FbxNode("C", ["OO", 3002, 2002]), FbxNode("C", ["OP", 4001, 3002, "DiffuseColor"])])
    header = FbxNode("FBXHeaderExtension", [], [FbxNode("FBXVersion", [("I", version)])])
    objects = FbxNode("Objects", [], [geo1, geo2, model1, model2, mat_a, mat_b, tex])
    return fbx_bytes([header, objects, conns], version)
