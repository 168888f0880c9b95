"""Cubemap sampling and direction/face math (counterpart of
sailor_tpu/kernels/cubemap.py; RHICubemap, ComputeEquirect2Cube.shader).

A cubemap is a (6, R, R, C) tensor in the face order +X, -X, +Y, -Y, +Z,
-Z. Every function is plain PyTorch on its inputs' device; the two that
take no tensor run on the card unless the caller names another device.
"""

from __future__ import annotations

import math

import torch

from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core.math3d import fma
from sailor_tpu_torch.kernels import sampling


def face_directions(resolution: int, device=None):
    """(6, R, R, 3) unit world direction of every texel centre."""
    dev = resolve_device(device)
    a = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) / resolution * 2.0 - 1.0
    v, u = torch.meshgrid(a, a, indexing="ij")  # u right, v down
    one = torch.ones_like(u)
    faces = torch.stack([
        torch.stack([one, -v, -u], -1),    # +X
        torch.stack([-one, -v, u], -1),    # -X
        torch.stack([u, one, v], -1),      # +Y
        torch.stack([u, -one, -v], -1),    # -Y
        torch.stack([u, -v, one], -1),     # +Z
        torch.stack([-u, -v, -one], -1),   # -Z
    ])
    return faces / torch.linalg.vector_norm(faces, dim=-1, keepdim=True)


def direction_to_face_uv(d):
    """Direction (..., 3) -> (face (...,) int32, u, v in [0, 1])."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5))).to(torch.int32)
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    u = torch.where(is_x, torch.where(x > 0, -z, z),
                    torch.where(is_y, x, torch.where(z > 0, x, -x)))
    v = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    return face, (u / ma + 1.0) * 0.5, (v / ma + 1.0) * 0.5


def _corners(u, v, r):
    """Bilinear corner coordinates and weights of face-local (u, v)."""
    fx, fy = u * r - 0.5, v * r - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    return x0f.to(torch.int64), y0f.to(torch.int64), (fx - x0f)[..., None], (fy - y0f)[..., None]


def _bilinear(flat, base, x0, y0, tx, ty, r):
    """The four clamped corners' blend, each lerp one fused multiply-add as
    the reference's compiled code rounds it."""
    def fetch(yy, xx):
        return flat[base + torch.clamp(yy, 0, r - 1) * r + torch.clamp(xx, 0, r - 1)]

    c00, c10 = fetch(y0, x0), fetch(y0, x0 + 1)
    c01, c11 = fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)
    tx, ty = tx.expand(c00.shape), ty.expand(c00.shape)
    top = fma(c10 - c00, tx, c00)
    bot = fma(c11 - c01, tx, c01)
    return fma(bot - top, ty, top)


def sample_cubemap(cube, d):
    """Bilinear cubemap sample (no seam filtering): one flat gather per
    corner into the stacked faces. ``cube`` (6, R, R, C)."""
    r = cube.shape[1]
    face, u, v = direction_to_face_uv(d)
    x0, y0, tx, ty = _corners(u, v, r)
    return _bilinear(cube.reshape(6 * r * r, cube.shape[-1]), face.long() * (r * r),
                     x0, y0, tx, ty, r)


def sample_cubemap_lod(mips, d, lod):
    """Trilinear sample across a list of cubemap mips: every mip is
    sampled and the two bracketing levels selected."""
    lod = torch.clamp(lod, 0.0, len(mips) - 1.0)
    lo = torch.floor(lod).to(torch.int32)
    frac = (lod - lo.to(torch.float32))[..., None]
    out = sample_cubemap(mips[0], d)
    acc_lo, acc_hi = out, out
    for m in range(len(mips)):
        s = sample_cubemap(mips[m], d)
        acc_lo = torch.where((lo == m)[..., None], s, acc_lo)
        acc_hi = torch.where((lo + 1 == m)[..., None], s, acc_hi)
    return acc_lo * (1.0 - frac) + acc_hi * frac


def sample_cubemap_lod_stack(stack, d, lod):
    """Trilinear sample from a same-resolution mip stack (M, 6, R, R, C):
    the level is part of the flat index, so two levels x four corners."""
    m, _, r, _, c = stack.shape
    lod = torch.clamp(lod, 0.0, m - 1.0)
    lo = torch.floor(lod).to(torch.int64)
    hi = torch.clamp(lo + 1, max=m - 1)
    frac = (lod - lo.to(torch.float32))[..., None]
    face, u, v = direction_to_face_uv(d)
    x0, y0, tx, ty = _corners(u, v, r)
    flat = stack.reshape(m * 6 * r * r, c)

    def level(lv):
        return _bilinear(flat, (lv * 6 + face.long()) * (r * r), x0, y0, tx, ty, r)

    return level(lo) * (1.0 - frac) + level(hi) * frac


def upsample_cubemap(cube, resolution: int):
    """Bilinear per-face resize to (6, resolution, resolution, C): packs
    the prefiltered mips at one resolution at bake time."""
    if cube.shape[1] == resolution:
        return cube
    return torch.stack([sampling.blit(cube[f], (resolution, resolution)) for f in range(6)])


def equirect_to_cube(equirect, resolution: int):
    """Equirectangular (H, W, C) -> cubemap (6, R, R, C)
    (ComputeEquirect2Cube.shader)."""
    d = face_directions(resolution, equirect.device)
    u = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return sampling.sample_bilinear(equirect, torch.stack([u, v], dim=-1), wrap="repeat")


def render_cubemap(radiance_fn, resolution: int, device=None):
    """Bake a direction -> radiance function into a cubemap (the sky's
    environment map)."""
    return radiance_fn(face_directions(resolution, device))


def downsample_cubemap(cube):
    """2x box downsample of every face."""
    r2 = cube.shape[1] // 2
    q = cube[:, :r2 * 2, :r2 * 2].reshape(6, r2, 2, r2, 2, -1)
    return q.mean(dim=(2, 4))
