"""The material system (counterpart of sailor_tpu/assets/materials.py): the
``MaterialTable`` of per-material parameters, render queues and texture
tables, its constructor from host rows ``MaterialTable.from_host``, the
texture samplers that both the raster path and the path tracer call, and
the `.mat` side: ``MaterialAsset`` (the importer's YAML) and
``MaterialLibrary`` (.mat files -> one table, rebuilt on hot reload).

Host tables (numpy): ``stack_textures`` resizes every image to one size
and stacks them (N, S, S, 4); ``build_mip_stack`` packs a box-filtered mip
pyramid of every layer into one flat (N * TPL, 4) table;
``build_quad_stack_blocks`` packs, per material group, the 2x2 bilinear
footprint of every map at every (level, texel) into one row, so a
trilinear fetch of all maps is two row gathers; ``build_quad_stack`` is
the raster path's form of it (albedo RGBA and, where any material has one,
the normal map; the narrow alpha table of the Masked queue's groups; the
mip-0 rows split into their own table when asked). Samplers (torch, any
device): ``_sample_texture_stack`` (bilinear, mip 0),
``sample_texture_lod`` (trilinear over the mip table), both with the
per-layer clamp and nearest sampler state, and ``sample_quad_blocks``
(trilinear, or nearest-mip for the peel's alpha test, over the quad rows,
with the split mip-0 table). The path tracer calls the first and the last
with repeat addressing and bilinear filtering; the raster path reaches
them through the ``MaterialTable`` methods.

``build_quad_stack_blocks(quantize=...)`` stores its rows as u8 (sRGB
encoded where asked), as the reference does; the reference also packs four
u8 lanes into one int32 (``pack_u8_rows``), a TPU gather trick the port
leaves out: its u8 rows stay (R, C) ``uint8`` and decode to the same
samples. ``MaterialTable.from_arrays`` unpacks such int32 rows.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from sailor_tpu_torch.config import resolve_device

MIN_MIP = 4  # coarsest mip edge


def stack_textures(images: list, size: int) -> np.ndarray:
    """Resize decoded images to one (size, size) by nearest texel centres
    and stack them: (N, size, size, C) float32; an empty list gives
    (0, size, size, 4)."""
    if not images:
        return np.zeros((0, size, size, 4), np.float32)
    out = []
    for img in images:
        h, w = img.shape[:2]
        ys = (np.arange(size) + 0.5) * h / size
        xs = (np.arange(size) + 0.5) * w / size
        yi = np.clip(ys.astype(int), 0, h - 1)
        xi = np.clip(xs.astype(int), 0, w - 1)
        out.append(img[yi][:, xi])
    # C order, as the reference's device array comes back: numpy's means over
    # the mip pyramid sum in memory order
    return np.ascontiguousarray(np.stack(out), np.float32)


def _mip_sizes(s: int) -> tuple:
    sizes = []
    cur = s
    while cur >= MIN_MIP:
        sizes.append(cur)
        if cur == MIN_MIP:
            break
        cur //= 2
    return tuple(sizes)


def _mip_chain(img: np.ndarray, sizes) -> list:
    """Box-filtered pyramid of one (S, S, C) image for the size list."""
    out = [img]
    cur = img
    for _ in sizes[1:]:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        out.append(cur)
    return out


def build_mip_stack(stack: np.ndarray):
    """Pack a box-filtered mip pyramid of every layer into one flat
    (N * TPL, 4) float32 table: level l of layer i at rows
    [i * TPL + off_l, ...), row-major s_l x s_l. Returns (table, sizes)."""
    stack = np.ascontiguousarray(stack, np.float32)
    sizes = _mip_sizes(stack.shape[1])
    per_layer = [np.concatenate([lvl.reshape(-1, lvl.shape[-1])
                                 for lvl in _mip_chain(stack[i], sizes)], axis=0)
                 for i in range(stack.shape[0])]
    return np.concatenate(per_layer, axis=0).astype(np.float32), sizes


def _quad_fold(img: np.ndarray, clamp: bool) -> np.ndarray:
    """(S, S, C) -> (S*S, 4C) rows [c00 | c10 | c01 | c11], the +1
    neighbours folded by the wrap mode."""
    if clamp:
        s = img.shape[0]
        nx = np.minimum(np.arange(s) + 1, s - 1)
        right = img[:, nx]
        down = img[nx]
        diag = img[nx][:, nx]
    else:
        right = np.roll(img, -1, axis=1)
        down = np.roll(img, -1, axis=0)
        diag = np.roll(right, -1, axis=0)
    q = np.concatenate([img, right, down, diag], axis=-1)
    return q.reshape(-1, q.shape[-1])


def build_quad_stack_blocks(textures: np.ndarray, blocks: list, wrap: np.ndarray,
                            filt: np.ndarray, quantize: tuple | None = None):
    """Combined per-material quad mip stack over channel blocks.

    ``blocks``: (layers (M,) int, nch, neutral tuple) per map kind; a block
    whose layers are all -1 is dropped (the first is kept when none is
    live). Materials dedupe to groups of equal layer tuples; each group's
    rows pack the 2x2 footprint of every block at every (level, texel),
    neighbours folded by the wrap mode of the group's first present map,
    missing maps filled with their neutral. ``quantize``: per-block sRGB
    flags; the rows are then stored u8 (clipped to [0, 1], encoded with the
    1/2.2 power where flagged, rounded). Returns (rows, group (M,), gwrap,
    gfilt, block offsets ((off, nch), ...), sizes)."""
    textures = np.ascontiguousarray(textures, np.float32)
    sizes = _mip_sizes(textures.shape[1])
    live = [(np.asarray(ls, np.int64), nch, neutral) for (ls, nch, neutral) in blocks
            if bool((np.asarray(ls) >= 0).any())]
    if not live:
        live = [(np.asarray(blocks[0][0], np.int64),) + tuple(blocks[0][1:])]
    m = len(live[0][0])
    keys = {}
    group = np.zeros(m, np.int32)
    for mi in range(m):
        group[mi] = keys.setdefault(tuple(int(ls[mi]) for ls, _, _ in live), len(keys))
    chains = {}

    def chain(i):
        if i not in chains:
            chains[i] = _mip_chain(np.asarray(textures[i], np.float32), sizes)
        return chains[i]

    neutrals = [[np.broadcast_to(np.asarray(neutral, np.float32), (sz, sz, nch)).copy()
                 for sz in sizes] for _, nch, neutral in live]
    gwrap = np.zeros(len(keys), np.int32)
    gfilt = np.zeros(len(keys), np.int32)
    offsets, off = [], 0
    for _, nch, _ in live:
        offsets.append((off, nch))
        off += 4 * nch
    rows = []
    for key, gi in sorted(keys.items(), key=lambda kv: kv[1]):
        src = next((layer for layer in key if layer >= 0), -1)
        w = int(wrap[src]) if src >= 0 else 0
        gwrap[gi] = w
        gfilt[gi] = int(filt[src]) if src >= 0 else 0
        for li in range(len(sizes)):
            parts = [_quad_fold(chain(layer)[li][..., :nch] if layer >= 0
                                else neutrals[bi][li], clamp=w == 1)
                     for bi, (layer, (_, nch, _)) in enumerate(zip(key, live))]
            rows.append(np.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0])
    flat = np.concatenate(rows, axis=0).astype(np.float32)
    if quantize is not None:
        enc = np.empty_like(flat)
        for bi, (boff, nch) in enumerate(offsets):
            blk = np.clip(flat[:, boff:boff + 4 * nch], 0.0, 1.0)
            if bi < len(quantize) and quantize[bi]:
                blk = blk ** (1.0 / 2.2)
            enc[:, boff:boff + 4 * nch] = blk
        flat = np.round(enc * 255.0).astype(np.uint8)
    return flat, group, gwrap, gfilt, tuple(offsets), sizes


def _bilinear_setup(uv, s):
    """Texel origin (x0, y0) int and weights (tx, ty) (..., 1) at size s
    (an int or a per-sample int tensor)."""
    sf = s.to(torch.float32) if torch.is_tensor(s) else float(s)
    fx = uv[..., 0] * sf - 0.5
    fy = uv[..., 1] * sf - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    return (x0f.to(torch.int32), y0f.to(torch.int32),
            (fx - x0f)[..., None], (fy - y0f)[..., None])


def _lerp4(c00, c10, c01, c11, tx, ty):
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def _sampler_state(wrap, filt, safe):
    """Per-sample clamp mask and (..., 1) nearest mask of the layers
    ``safe`` from the per-layer ``wrap``/``filt`` (1 = clamp / nearest);
    None where the table is absent."""
    clamp_m = None if wrap is None else wrap[safe] == 1
    near = None if filt is None else (filt[safe] == 1)[..., None]
    return clamp_m, near


def _addr(i, s, clamp_m):
    """Texel index i at size s: repeat, or clamp to the edge where clamp_m."""
    rep = torch.remainder(i, s)
    if clamp_m is None:
        return rep
    edge = (torch.minimum(torch.clamp(i, min=0), s - 1) if torch.is_tensor(s)
            else torch.clamp(i, 0, s - 1))
    return torch.where(clamp_m, edge, rep)


def _sample_texture_stack(stack, layer, uv, wrap=None, filt=None):
    """Bilinear sample of (N, S, S, 4) at per-sample ``layer`` (clamped to
    a valid layer) and ``uv``; ``wrap``/``filt``: optional (N,) per-layer
    sampler state, 1 = clamp to the edge instead of repeat / nearest (the
    weights snapped) instead of bilinear."""
    n, s = stack.shape[0], stack.shape[1]
    safe = torch.clamp(layer, 0, n - 1).long()
    x0, y0, tx, ty = _bilinear_setup(uv, s)
    clamp_m, near = _sampler_state(wrap, filt, safe)
    if near is not None:
        tx = torch.where(near, torch.round(tx), tx)
        ty = torch.where(near, torch.round(ty), ty)
    flat = stack.reshape(-1, stack.shape[-1])

    def fetch(yy, xx):
        return flat[(safe * s + _addr(yy, s, clamp_m)) * s + _addr(xx, s, clamp_m)]

    return _lerp4(fetch(y0, x0), fetch(y0, x0 + 1), fetch(y0 + 1, x0),
                  fetch(y0 + 1, x0 + 1), tx, ty)


def _levels(sizes, lod, nlev, device):
    """Per-level sizes and row offsets of ``sizes`` as tensors, the rows of
    one group, and (l0, lf) of ``lod`` clamped to [0, nlev - 1]."""
    offs, acc = [], 0
    for s in sizes:
        offs.append(acc)
        acc += s * s
    lod = torch.clamp(lod, 0.0, nlev - 1.0)
    l0f = torch.floor(lod)
    return (torch.tensor(sizes, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int64, device=device), acc,
            l0f.to(torch.int64), (lod - l0f)[..., None])


def sample_texture_lod(flat, n_layers: int, mip_sizes: tuple, layer, uv, lod,
                       wrap=None, filt=None):
    """Trilinear sample from ``build_mip_stack``'s table: bilinear at the
    floor and the next level of the clamped ``lod``, then a lerp; ``wrap``/
    ``filt`` as in ``_sample_texture_stack``."""
    nlev = len(mip_sizes)
    sizes, offs, tpl, l0, lf = _levels(mip_sizes, lod, nlev, flat.device)
    safe = torch.clamp(layer, 0, n_layers - 1).long()
    base = safe * tpl
    clamp_m, near = _sampler_state(wrap, filt, safe)

    def bilinear(lvl):
        s = sizes[lvl]
        off = base + offs[lvl]
        x0, y0, tx, ty = _bilinear_setup(uv, s)
        if near is not None:
            tx = torch.where(near, torch.round(tx), tx)
            ty = torch.where(near, torch.round(ty), ty)

        def fetch(yy, xx):
            return flat[off + _addr(yy, s, clamp_m).long() * s + _addr(xx, s, clamp_m)]

        return _lerp4(fetch(y0, x0), fetch(y0, x0 + 1), fetch(y0 + 1, x0),
                      fetch(y0 + 1, x0 + 1), tx, ty)

    lo = bilinear(l0)
    hi = bilinear(torch.clamp(l0 + 1, max=nlev - 1))
    return lo + (hi - lo) * lf


def sample_quad_blocks(flat, mip_sizes: tuple, block_offsets: tuple, group, uv, lod,
                       wrapc, nearest, srgb: tuple = (), flat0=None,
                       trilinear: bool = True):
    """Fetch every channel block from ``build_quad_stack_blocks``' rows:
    one row gather a level. ``flat`` is float32, or uint8 (decoded to
    [0, 1] before the filter, with the 2.2 power on the blocks ``srgb``
    flags); ``group``, ``wrapc`` (clamp addressing) and ``nearest`` (snapped
    weights) are per sample. ``flat0``: the split mip-0 table
    (``build_quad_stack(split_mip0=True)``), ``flat`` then holding levels
    1.. only. ``trilinear=False``: the nearest mip (round(lod)), one gather,
    as the masked peel's alpha test takes it. Returns one (..., nch) tensor
    per block."""
    quantized = flat.dtype == torch.uint8
    nlev = len(mip_sizes)
    split = flat0 is not None
    sizes, offs, tpl, l0, lf = _levels(mip_sizes[1:] if split else mip_sizes, lod, nlev,
                                       flat.device)
    base = group.long() * tpl
    base0 = group.long() * (mip_sizes[0] * mip_sizes[0]) if split else None
    near = nearest[..., None]

    def decode(q):
        if not quantized:
            return q
        q = q.to(torch.float32) * (1.0 / 255.0)
        if any(srgb):
            q = torch.cat([q[..., b:b + 4 * n] ** 2.2 if bi < len(srgb) and srgb[bi]
                           else q[..., b:b + 4 * n]
                           for bi, (b, n) in enumerate(block_offsets)], -1)
        return q

    def taps_from(table, tbase, s, off):
        x0, y0, tx, ty = _bilinear_setup(uv, s)
        tx = torch.where(near, torch.round(tx), tx)
        ty = torch.where(near, torch.round(ty), ty)
        # clamp: snap the weight at the low edge; the high edge is folded
        # into the rows at build (the edge quad repeats its own texel)
        tx = torch.where((wrapc & (x0 < 0))[..., None], 0.0, tx)
        ty = torch.where((wrapc & (y0 < 0))[..., None], 0.0, ty)
        xw = _addr(x0, s, wrapc)
        yw = _addr(y0, s, wrapc)
        q = decode(table[tbase + off + yw.long() * s + xw])
        w00 = (1.0 - tx) * (1.0 - ty)
        w10 = tx * (1.0 - ty)
        w01 = (1.0 - tx) * ty
        w11 = tx * ty
        return [q[..., b:b + n] * w00 + q[..., b + n:b + 2 * n] * w10
                + q[..., b + 2 * n:b + 3 * n] * w01 + q[..., b + 3 * n:b + 4 * n] * w11
                for b, n in block_offsets]

    def taps(lvl):
        # lvl indexes the full level list; the split table starts at level 1
        i = torch.clamp(lvl - 1, min=0) if split else lvl
        return taps_from(flat, base, sizes[i], offs[i])

    def level(lvl):
        if not split:
            return taps(lvl)
        rest = taps(torch.clamp(lvl, min=1))
        mip0 = taps_from(flat0, base0, mip_sizes[0], 0)
        is0 = (lvl == 0)[..., None]
        return [torch.where(is0, a0, ar) for a0, ar in zip(mip0, rest)]

    if not trilinear:
        return level(torch.round(torch.clamp(lod, 0.0, nlev - 1.0)).to(torch.int64))
    t0 = level(l0)
    t1 = taps(torch.clamp(l0 + 1, max=nlev - 1))
    return [a + (b - a) * lf for a, b in zip(t0, t1)]


def build_quad_stack(textures: np.ndarray, a_tex: np.ndarray, n_tex: np.ndarray,
                     wrap: np.ndarray, filt: np.ndarray, quantize: bool = True,
                     masked: np.ndarray | None = None, split_mip0: bool = True):
    """The raster path's combined stack: an albedo RGBA block and, when
    any material has a normal map, a normal RGB block (u8 rows with the
    albedo sRGB-encoded where ``quantize``). ``masked``: (M,) bool, the
    materials of the Masked queue, whose groups alone get rows in the
    narrow (Gm * TPL, 4) alpha table of the peel's alpha test
    (``alpha_group`` maps material -> its block there; every group when
    None). ``split_mip0``: mip 0 moves to its own table and ``rows`` keeps
    levels 1.. . Returns (rows, rows_mip0, group, gwrap, gfilt, has_normal,
    offsets ((kind, (off, nch)), ...), srgb, alpha_rows, alpha_group,
    sizes), numpy."""
    has_normal = bool((np.asarray(n_tex) >= 0).any())
    has_albedo = bool((np.asarray(a_tex) >= 0).any())
    blocks = [(a_tex, 4, (1.0, 1.0, 1.0, 1.0))]
    qflags = [True]  # albedo: the sRGB transfer
    if has_normal:
        blocks.append((n_tex, 3, (0.5, 0.5, 1.0)))
        qflags.append(False)  # tangent-space vectors stay linear
    rows, group, gwrap, gfilt, offs, sizes = build_quad_stack_blocks(
        textures, blocks, wrap, filt, quantize=tuple(qflags) if quantize else None)
    # an all-absent block is dropped (the first kept when none is live):
    # label the survivors so the sampler reads the layout it got
    kinds = [k for k, present in (("albedo", has_albedo), ("normal", has_normal))
             if present] or ["albedo"]
    offsets = tuple(zip(kinds, offs))
    srgb = tuple(k == "albedo" for k in kinds) if quantize else ()
    tpl = sum(s * s for s in sizes)
    ngroups = rows.shape[0] // tpl
    alpha_rows = alpha_group = None
    if kinds[0] == "albedo":
        a_off = offsets[0][1][0]
        alpha_full = rows[:, [a_off + 3, a_off + 7, a_off + 11, a_off + 15]]
        gm = (np.unique(group[np.asarray(masked, bool)]) if masked is not None
              else np.arange(ngroups))
        if gm.size:
            alpha_rows = np.ascontiguousarray(
                alpha_full.reshape(ngroups, tpl, -1)[gm].reshape(gm.size * tpl, -1))
            remap = np.zeros(ngroups, np.int32)
            remap[gm] = np.arange(gm.size, dtype=np.int32)
            alpha_group = remap[group]
    rows_mip0 = None
    if split_mip0 and len(sizes) > 1:
        s0sq = sizes[0] * sizes[0]
        blocks3 = rows.reshape(ngroups, tpl, rows.shape[1])
        rows_mip0 = np.ascontiguousarray(blocks3[:, :s0sq].reshape(ngroups * s0sq, -1))
        rows = np.ascontiguousarray(blocks3[:, s0sq:].reshape(ngroups * (tpl - s0sq), -1))
    return (rows, rows_mip0, group, gwrap, gfilt, has_normal, offsets, srgb,
            alpha_rows, alpha_group, sizes)


QUEUE_OPAQUE = 0
QUEUE_MASKED = 1
QUEUE_TRANSPARENT = 2
_QUEUE_NAMES = {"Opaque": 0, "Masked": 1, "Transparent": 2}

#: the MaterialTable's tensor fields, then its host fields
TENSOR_FIELDS = ("albedo", "metallic", "roughness", "emissive", "albedo_texture",
                 "normal_texture", "textures", "queue", "alpha_cutoff", "opacity",
                 "tex_lod", "tex_wrap", "tex_filter", "tex_quad", "quad_group",
                 "quad_wrap", "quad_filter", "tex_quad_alpha", "alpha_group",
                 "tex_quad_mip0")
HOST_FIELDS = ("has_masked", "has_transparent", "mip_sizes", "quad_has_normal",
               "quad_offsets", "quad_srgb")


@dataclasses.dataclass
class MaterialTable:
    """Per-material parameters, render state and texture tables on one
    device. ``queue``: 0 Opaque, 1 Masked (alpha-tested against
    ``alpha_cutoff``), 2 Transparent (blended by ``opacity``); the host
    bools ``has_masked``/``has_transparent`` let the frame skip a queue's
    passes. The texture tables are those of ``from_host``: the stack of
    mip 0 (N, S, S, 4), the mip table with per-layer ``tex_wrap`` and
    ``tex_filter``, and the combined quad rows with their groups, sampler
    state, block layout ``quad_offsets`` and sRGB flags ``quad_srgb``."""

    albedo: torch.Tensor          # (M, 3)
    metallic: torch.Tensor        # (M,)
    roughness: torch.Tensor       # (M,)
    emissive: torch.Tensor        # (M, 3)
    albedo_texture: torch.Tensor  # (M,) int32 layer or -1
    normal_texture: torch.Tensor  # (M,) int32 layer or -1 (tangent-space map)
    textures: torch.Tensor        # (N, S, S, 4) linear RGBA, mip 0
    queue: torch.Tensor           # (M,) int32
    alpha_cutoff: torch.Tensor    # (M,)
    opacity: torch.Tensor         # (M,)
    has_masked: bool = False
    has_transparent: bool = False
    tex_lod: torch.Tensor | None = None      # (N * TPL, 4) mips 0..L-1
    tex_wrap: torch.Tensor | None = None     # (N,) int32 0 repeat, 1 clamp
    tex_filter: torch.Tensor | None = None   # (N,) int32 0 bilinear, 1 nearest
    mip_sizes: tuple = ()
    tex_quad: torch.Tensor | None = None     # (G * TPL, 16 | 28) f32 or u8
    quad_group: torch.Tensor | None = None   # (M,) int32 material -> group
    quad_wrap: torch.Tensor | None = None    # (G,) int32
    quad_filter: torch.Tensor | None = None  # (G,) int32
    quad_has_normal: bool = False
    quad_offsets: tuple = ()                 # ((kind, (offset, nch)), ...)
    quad_srgb: tuple = ()                    # per-block sRGB flags of u8 rows
    tex_quad_alpha: torch.Tensor | None = None  # (Gm * TPL, 4) Masked groups' alpha
    alpha_group: torch.Tensor | None = None     # (M,) material -> alpha block
    tex_quad_mip0: torch.Tensor | None = None   # split mip-0 rows

    @property
    def has_mips(self) -> bool:
        return self.tex_lod is not None and len(self.mip_sizes) > 1

    @property
    def has_quad(self) -> bool:
        return self.tex_quad is not None and len(self.mip_sizes) > 1

    def sample_combined(self, mat_id, uv, lod):
        """One fetch of every map from the combined quad rows: (albedo RGBA,
        tangent-space normal in [-1, 1] or None, has-normal-map mask)."""
        g = self.quad_group[mat_id.long()].long()
        offsets = self.quad_offsets or (
            (("albedo", (0, 4)), ("normal", (16, 3))) if self.quad_has_normal
            else (("albedo", (0, 4)),))
        out = sample_quad_blocks(
            self.tex_quad, self.mip_sizes, tuple(o for _, o in offsets), g, uv, lod,
            wrapc=self.quad_wrap[g] == 1, nearest=self.quad_filter[g] == 1,
            srgb=self.quad_srgb, flat0=self.tex_quad_mip0)
        bmap = dict(zip((k for k, _ in offsets), out))
        albedo = bmap.get("albedo")
        if albedo is None:  # a normal-map-only stack: the albedo block was dropped
            albedo = torch.ones(uv.shape[:-1] + (4,), device=uv.device)
        if "normal" in bmap:
            return albedo, bmap["normal"] * 2.0 - 1.0, self.normal_texture[mat_id.long()] >= 0
        return albedo, None, torch.zeros(mat_id.shape, dtype=torch.bool, device=uv.device)

    def sample_alpha(self, mat_id, uv, lod):
        """The albedo map's alpha alone, from the narrow alpha table at the
        nearest mip (the masked peel's alpha test); from ``sample_combined``
        when the table has no alpha rows."""
        if self.tex_quad_alpha is None:
            return self.sample_combined(mat_id, uv, lod)[0][..., 3]
        mid = mat_id.long()
        g = self.quad_group[mid].long()
        ga = self.alpha_group[mid].long() if self.alpha_group is not None else g
        out = sample_quad_blocks(
            self.tex_quad_alpha, self.mip_sizes, ((0, 1),), ga, uv, lod,
            wrapc=self.quad_wrap[g] == 1, nearest=self.quad_filter[g] == 1,
            srgb=self.quad_srgb[:1], trilinear=False)
        return out[0][..., 0]

    def sample_normal(self, mat_id, uv, lod=None):
        """Tangent-space normal from the material's normal map: ((..., 3) in
        [-1, 1], (...,) has-map mask)."""
        layer = self.normal_texture[mat_id.long()]
        if self.textures.shape[0] == 0:
            z = torch.zeros(mat_id.shape + (3,), device=uv.device)
            z[..., 2] = 1.0
            return z, torch.zeros(mat_id.shape, dtype=torch.bool, device=uv.device)
        tex = self.sample_texture(layer, uv, lod)
        return tex[..., :3] * 2.0 - 1.0, layer >= 0

    def sample_texture(self, layer, uv, lod=None):
        """The texture stack at per-sample ``layer``: trilinear over the
        mips with a ``lod`` and a mip table, bilinear mip 0 otherwise."""
        if lod is not None and self.has_mips:
            return sample_texture_lod(self.tex_lod, self.textures.shape[0], self.mip_sizes,
                                      layer, uv, lod, wrap=self.tex_wrap,
                                      filt=self.tex_filter)
        return _sample_texture_stack(self.textures, layer, uv, wrap=self.tex_wrap,
                                     filt=self.tex_filter)

    def sample(self, mat_id, uv, lod=None):
        """Per-sample material fetch: (albedo RGBA, metallic, roughness,
        emissive)."""
        mid = mat_id.long()
        alb = self.albedo[mid]
        met = self.metallic[mid]
        rough = self.roughness[mid]
        emis = self.emissive[mid]
        if self.has_quad and lod is not None:
            tex = self.sample_combined(mat_id, uv, lod)[0]
            alb = alb * tex[..., :3]
            alpha = tex[..., 3]
        elif self.textures.shape[0] > 0:
            layer = self.albedo_texture[mid]
            tex = self.sample_texture(layer, uv, lod)
            alb = alb * torch.where((layer >= 0)[..., None], tex[..., :3], 1.0)
            alpha = torch.where(layer >= 0, tex[..., 3], 1.0)
        else:
            alpha = torch.ones_like(met)
        return torch.cat([alb, alpha[..., None]], -1), met, rough, emis

    @classmethod
    def from_host(cls, table: dict, images: list | None = None, texture_size: int = 256,
                  sampler_meta: list | None = None, mips: bool = True,
                  device="cuda") -> "MaterialTable":
        """Build the table from host rows: ``table`` holds per-material
        lists (albedo, metallic, roughness, emissive and, optionally,
        albedo_texture, normal_texture, queue (ints or "Opaque"/"Masked"/
        "Transparent"), alpha_cutoff (0.5), opacity (1)); ``images`` the
        decoded textures, resized to ``texture_size``; ``sampler_meta``
        per texture ``{"clamping": "Clamp"|"Repeat", "filtration":
        "Nearest"|"Bilinear"}``. With ``mips`` (and textures) the mip table
        and the quad rows are built: u8 rows unless the environment sets
        SAILOR_QUAD_U8=0, the mip-0 rows split when SAILOR_QUAD_SPLIT=1,
        as the reference reads them."""
        textures = stack_textures(images or [], texture_size)
        m = len(table["albedo"])
        queues = np.asarray([_QUEUE_NAMES.get(q, q) if isinstance(q, str) else q
                             for q in table.get("queue", np.zeros(m, np.int32))], np.int32)
        n_tex = textures.shape[0]
        wrap = np.zeros(n_tex, np.int32)
        filt = np.zeros(n_tex, np.int32)
        for i, meta in enumerate(sampler_meta or []):
            if i >= n_tex or not meta:
                continue
            wrap[i] = 1 if str(meta.get("clamping", "Repeat")).lower() == "clamp" else 0
            filt[i] = 1 if str(meta.get("filtration", "Bilinear")).lower() == "nearest" else 0
        a_tex = np.asarray(table.get("albedo_texture", np.full(m, -1, np.int32)), np.int32)
        n_tx = np.asarray(table.get("normal_texture", np.full(m, -1, np.int32)), np.int32)
        fields = dict(
            albedo=np.asarray(table["albedo"], np.float32),
            metallic=np.asarray(table["metallic"], np.float32),
            roughness=np.asarray(table["roughness"], np.float32),
            emissive=np.asarray(table["emissive"], np.float32),
            albedo_texture=a_tex, normal_texture=n_tx, textures=textures, queue=queues,
            alpha_cutoff=np.asarray(table.get("alpha_cutoff", np.full(m, 0.5)), np.float32),
            opacity=np.asarray(table.get("opacity", np.ones(m)), np.float32),
            has_masked=bool((queues == QUEUE_MASKED).any()),
            has_transparent=bool((queues == QUEUE_TRANSPARENT).any()))
        if n_tex:
            fields.update(tex_wrap=wrap, tex_filter=filt)
        if mips and n_tex:
            fields["tex_lod"], sizes = build_mip_stack(textures)
            quad = build_quad_stack(
                textures, a_tex, n_tx, wrap, filt,
                quantize=os.environ.get("SAILOR_QUAD_U8", "1") == "1",
                masked=queues == QUEUE_MASKED,
                split_mip0=os.environ.get("SAILOR_QUAD_SPLIT", "0") == "1")
            fields.update(zip(("tex_quad", "tex_quad_mip0", "quad_group", "quad_wrap",
                               "quad_filter", "quad_has_normal", "quad_offsets",
                               "quad_srgb", "tex_quad_alpha", "alpha_group", "mip_sizes"),
                              quad))
        return cls.from_arrays(fields, device=device)

    @classmethod
    def from_arrays(cls, arrays: dict, prefix: str = "", device="cuda") -> "MaterialTable":
        """The table from numpy arrays under ``prefix + field`` (the tensor
        fields, absent ones None) and the host fields as given, e.g. those
        of another implementation's table (``scene_from_numpy`` reads
        ``materials.<field>``). Rows of u8 lanes packed four to
        an int32 (``tex_quad`` and ``tex_quad_mip0`` of the reference's u8
        form) are unpacked to (R, C) uint8."""
        dev = resolve_device(device)
        host = {f: arrays[prefix + f] for f in HOST_FIELDS if prefix + f in arrays}
        host = {k: bool(v) if k.startswith(("has_", "quad_has")) else v
                for k, v in host.items()}
        if "mip_sizes" in host:
            host["mip_sizes"] = tuple(int(s) for s in host["mip_sizes"])
        if "quad_srgb" in host:
            host["quad_srgb"] = tuple(bool(b) for b in host["quad_srgb"])
        if "quad_offsets" in host:
            host["quad_offsets"] = tuple((str(k), (int(o), int(n)))
                                         for k, (o, n) in host["quad_offsets"])
        nbytes = sum(4 * n for _, (_, n) in host.get("quad_offsets", ()))
        out = {}
        for f in TENSOR_FIELDS:
            a = arrays.get(prefix + f)
            if a is None:
                out[f] = None
                continue
            a = np.array(a, order="C")
            if f in ("tex_quad", "tex_quad_mip0") and a.dtype == np.int32:
                a = np.ascontiguousarray(a.view(np.uint8)[:, :nbytes])
            out[f] = torch.from_numpy(a).to(dev)
        return cls(**out, **host)


class MaterialLibrary:
    """Ordered set of .mat assets -> one MaterialTable, rebuilt on hot
    reload (counterpart of sailor_tpu/assets/materials.py's; the consumer
    side of Material::OnHotReload, MaterialImporter.cpp:53): a hot-reloaded
    material asset rebuilds the table, so the next frame reflects the edit;
    ``version`` counts the builds, so renderers can see the swap.

    ``paths``: .mat file paths; list index == the material_id mesh
    renderers reference (MeshRendererComponent.material_id). Sampler keys
    ``baseSampler``/``albedoSampler`` -> albedo texture,
    ``normalSampler`` -> normal map, loaded through the same registry.
    The table lives on ``device`` (the card unless the caller asks for
    another).
    """

    def __init__(self, registry, paths, texture_size: int = 64, mips: bool = False,
                 device="cuda"):
        self.registry = registry
        self.paths = [str(p) for p in paths]
        self.texture_size = texture_size
        self.mips = mips
        self.device = resolve_device(device)
        self.version = 0
        self.table: MaterialTable | None = None
        registry.add_hot_reload_listener(self._on_hot_reload)
        self.rebuild()

    def _on_hot_reload(self, info) -> None:
        if info.path in self.paths:
            self.rebuild()

    def rebuild(self) -> None:
        assets = [self.registry.load(p) for p in self.paths]
        rows = [a.to_table_row() for a in assets]
        table = {k: [r[k] for r in rows] for k in rows[0]}
        images, tex_index = [], {}
        a_tex = np.full(len(assets), -1, np.int32)
        n_tex = np.full(len(assets), -1, np.int32)
        for i, a in enumerate(assets):
            for key, target in (("baseSampler", a_tex), ("albedoSampler", a_tex),
                                ("normalSampler", n_tex)):
                rel = a.samplers.get(key)
                if not rel:
                    continue
                if rel not in tex_index:
                    tex_index[rel] = len(images)
                    images.append(np.asarray(self.registry.load(rel)))
                target[i] = tex_index[rel]
        table["albedo_texture"] = a_tex
        table["normal_texture"] = n_tex
        self.table = MaterialTable.from_host(table, images, texture_size=self.texture_size,
                                             mips=self.mips, device=self.device)
        self.version += 1


@dataclasses.dataclass
class MaterialAsset:
    """Parsed .mat file: render state + shader + uniforms
    (Content/Models/*/materials/*.mat schema)."""

    name: str = "material"
    render_queue: str = "Opaque"     # Opaque / Masked / Transparent
    blend_mode: str = "None"
    cull_mode: str = "Back"
    depth_bias: float = 0.0
    enable_depth_test: bool = True
    shader: str = "Standard"
    defines: tuple = ()
    uniforms: dict = dataclasses.field(default_factory=dict)
    samplers: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, text: str, name: str = "material") -> "MaterialAsset":
        import yaml  # PyYAML: needed only to read .mat files

        doc = yaml.safe_load(text) or {}
        return cls(
            name=doc.get("name", name),
            render_queue=doc.get("renderQueue", "Opaque"),
            blend_mode=doc.get("blendMode", "None"),
            cull_mode=doc.get("cullMode", "Back"),
            depth_bias=float(doc.get("depthBias", 0.0)),
            enable_depth_test=bool(doc.get("enableDepthTest", True)),
            shader=doc.get("shader", "Standard"),
            defines=tuple(doc.get("defines", []) or []),
            uniforms=dict(doc.get("uniformsVec4", {}) or {})
            | {k: [v] for k, v in (doc.get("uniformsFloat", {}) or {}).items()},
            samplers=dict(doc.get("samplers", {}) or {}),
        )

    def to_table_row(self) -> dict:
        """Flatten uniforms into MaterialTable row values."""
        albedo = self.uniforms.get("material.albedo", [0.8, 0.8, 0.8, 1.0])
        queue = _QUEUE_NAMES.get(self.render_queue, 0)
        return {
            "albedo": albedo[:3],
            "metallic": float(self.uniforms.get("material.metallic", [0.0])[0]),
            "roughness": float(self.uniforms.get("material.roughness", [0.6])[0]),
            "emissive": self.uniforms.get("material.emission", [0, 0, 0, 0])[:3],
            "queue": queue,
            "alpha_cutoff": float(self.uniforms.get("material.alphaCutoff", [0.5])[0]),
            "opacity": (float(albedo[3]) if len(albedo) > 3 and queue == QUEUE_TRANSPARENT
                        else 1.0),
        }
