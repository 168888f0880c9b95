"""Texture stacks and their samplers, the path tracer's side (counterpart of
the texture functions of sailor_tpu/assets/materials.py).

Host tables (numpy): ``stack_textures`` resizes every image to one size
and stacks them (N, S, S, 4); ``build_mip_stack`` packs a box-filtered mip
pyramid of every layer into one flat (N * TPL, 4) table;
``build_quad_stack_blocks`` packs, per material group, the 2x2 bilinear
footprint of every map at every (level, texel) into one row, so a
trilinear fetch of all maps is two row gathers. Samplers (torch, any
device): ``_sample_texture_stack`` (bilinear, mip 0), ``sample_texture_lod``
(trilinear over the mip table) and ``sample_quad_blocks`` (trilinear over
the quad rows). The path tracer calls the first and the last: every
textured scene with a mip pyramid has quad rows, so the reference's
tracer reaches ``sample_texture_lod`` only in a case that cannot occur.

``build_quad_stack_blocks(quantize=...)`` stores its rows as u8 (sRGB
encoded where asked), as the reference does; the reference also packs four
u8 lanes into one int32, a TPU gather trick the port leaves out, so its u8
rows stay (R, C) ``uint8``. The samplers take repeat addressing and
bilinear filtering, as the tracer calls them: the reference's per-layer
clamp and nearest sampler state (``wrap``/``filt``), the split mip-0 table
and the nearest-mip form serve the raster path, which is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _sample_texture_stack(stack, layer, uv):
    """Bilinear, repeat-addressed sample of (N, S, S, 4) at per-sample
    ``layer`` (clamped to a valid layer) and ``uv``."""
    n, s = stack.shape[0], stack.shape[1]
    safe = torch.clamp(layer, 0, n - 1).long()
    x0, y0, tx, ty = _bilinear_setup(uv, s)
    flat = stack.reshape(-1, stack.shape[-1])

    def fetch(yy, xx):
        return flat[(safe * s + torch.remainder(yy, s)) * s + torch.remainder(xx, s)]

    return _lerp4(fetch(y0, x0), fetch(y0, x0 + 1), fetch(y0 + 1, x0),
                  fetch(y0 + 1, x0 + 1), tx, ty)


def _levels(mip_sizes, lod, device):
    """Per-level sizes and row offsets as tensors, and (l0, lf) of the
    clamped fractional ``lod``."""
    offs, acc = [], 0
    for s in mip_sizes:
        offs.append(acc)
        acc += s * s
    lod = torch.clamp(lod, 0.0, len(mip_sizes) - 1.0)
    l0f = torch.floor(lod)
    return (torch.tensor(mip_sizes, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int64, device=device), acc,
            l0f.to(torch.int64), (lod - l0f)[..., None])


def sample_texture_lod(flat, n_layers: int, mip_sizes: tuple, layer, uv, lod):
    """Trilinear sample from ``build_mip_stack``'s table: bilinear at the
    floor and the next level of the clamped ``lod``, then a lerp."""
    sizes, offs, tpl, l0, lf = _levels(mip_sizes, lod, flat.device)
    base = torch.clamp(layer, 0, n_layers - 1).long() * tpl
    nlev = len(mip_sizes)

    def bilinear(lvl):
        s = sizes[lvl]
        off = base + offs[lvl]
        x0, y0, tx, ty = _bilinear_setup(uv, s)

        def fetch(yy, xx):
            return flat[off + torch.remainder(yy, s).long() * s + torch.remainder(xx, s)]

        return _lerp4(fetch(y0, x0), fetch(y0, x0 + 1), fetch(y0 + 1, x0),
                      fetch(y0 + 1, x0 + 1), tx, ty)

    lo = bilinear(l0)
    hi = bilinear(torch.clamp(l0 + 1, max=nlev - 1))
    return lo + (hi - lo) * lf


def sample_quad_blocks(flat, mip_sizes: tuple, block_offsets: tuple, group, uv, lod,
                       wrapc, nearest, srgb: tuple = ()):
    """Trilinear fetch of every channel block from ``build_quad_stack_blocks``'
    rows: one row gather a level. ``flat`` is float32, or uint8 (decoded to
    [0, 1] before the filter, with the 2.2 power on the blocks ``srgb``
    flags); ``group``, ``wrapc`` (clamp addressing) and ``nearest`` (snapped
    weights) are per sample. Returns one (..., nch) tensor per block."""
    quantized = flat.dtype == torch.uint8
    sizes, offs, tpl, l0, lf = _levels(mip_sizes, lod, flat.device)
    base = group.long() * tpl
    nlev = len(mip_sizes)
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

    def taps(lvl):
        s = sizes[lvl]
        x0, y0, tx, ty = _bilinear_setup(uv, s)
        tx = torch.where(near, torch.round(tx), tx)
        ty = torch.where(near, torch.round(ty), ty)
        # clamp: snap the weight at the low edge; the high edge is folded
        # into the rows at build (the edge quad repeats its own texel)
        tx = torch.where((wrapc & (x0 < 0))[..., None], 0.0, tx)
        ty = torch.where((wrapc & (y0 < 0))[..., None], 0.0, ty)
        xw = torch.where(wrapc, torch.minimum(torch.clamp(x0, min=0), s - 1),
                         torch.remainder(x0, s))
        yw = torch.where(wrapc, torch.minimum(torch.clamp(y0, min=0), s - 1),
                         torch.remainder(y0, s))
        q = decode(flat[base + offs[lvl] + yw.long() * s + xw])
        w00 = (1.0 - tx) * (1.0 - ty)
        w10 = tx * (1.0 - ty)
        w01 = (1.0 - tx) * ty
        w11 = tx * ty
        return [q[..., b:b + n] * w00 + q[..., b + n:b + 2 * n] * w10
                + q[..., b + 2 * n:b + 3 * n] * w01 + q[..., b + 3 * n:b + 4 * n] * w11
                for b, n in block_offsets]

    t0 = taps(l0)
    t1 = taps(torch.clamp(l0 + 1, max=nlev - 1))
    return [a + (b - a) * lf for a, b in zip(t0, t1)]
