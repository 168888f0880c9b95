"""Screen-space post passes (counterpart of sailor_tpu/kernels/postprocess.py;
LinearizeDepth.shader, HBAO.shader, MotionBlur.shader, SunShafts.shader,
ChromaticAberation.shader): dense per-pixel math over whole images on
their device, and the row-sharded forms (``exchange_row_halo``,
``hbao_sharded``; ``motion_blur`` and ``sun_shafts`` given a shard's
communicator) that equal the whole frame's pass sliced.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import sampling
from sailor_tpu_torch.raster.interpolate import _pixel_ndc

# HBAO direction set (8 directions, HBAO.shader Directions)
_DIRS = np.asarray([
    [0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [-1.0, 0.0],
    [-0.7071069, 0.7071068], [0.7071068, 0.7071069],
    [0.7071069, -0.7071068], [-0.7071068, -0.7071069],
], np.float32)


def linearize_depth(depth_rev, z_near, z_far):
    """Reverse-Z ndc depth -> positive view-space distance; background (0)
    maps to z_far."""
    lin = z_near * z_far / (depth_rev * (z_far - z_near) + z_near)
    return torch.where(depth_rev > 0.0, lin, torch.broadcast_to(z_far, lin.shape))


def window_sum(x, q: int):
    """Sums of the q x q blocks of the leading two axes (partial blocks at
    the far edges dropped), added in the window's row-major order as the
    reference's ``reduce_window`` adds them."""
    h, w = (x.shape[0] // q) * q, (x.shape[1] // q) * q
    acc = None
    for dy in range(q):
        for dx in range(q):
            tap = x[dy:h:q, dx:w:q]
            acc = tap if acc is None else acc + tap
    return acc


def _pixel_uv(ys, xs, width: int, full_height: int, row0=0):
    """(u, v) grids of the pixel centres at rows ``ys`` and columns ``xs``
    (float32 indices): ((x + 0.5) / width, (y + 0.5 + row0) / full_height)."""
    v, u = torch.meshgrid((ys + 0.5 + row0) / full_height, (xs + 0.5) / width, indexing="ij")
    return u, v


def _arange(n: int, device, step: int = 1):
    return torch.arange(n, dtype=torch.float32, device=device) * step


def reconstruct_view_pos(linear_depth, inv_projection, height: int, width: int, row0=0,
                         full_height: int | None = None, clamp_rows: bool = False):
    """View-space position of every pixel from its linear depth, rounded
    as the reference's compiled pass: the pixel NDC as
    ``interpolate._pixel_ndc`` makes it, and (p / p_w) / (-p_z / p_w)
    with p_w cancelled, i.e. p / -p_z. ``clamp_rows``: global rows
    clamped into [0, full height), so halo rows past the viewport take the
    edge row's coordinates, as the whole frame's clamped shifts do."""
    fh = full_height if full_height is not None else height
    ndc_x, ndc_y = _pixel_ndc(height, width, row0, fh, inv_projection.device,
                              clamp_rows=clamp_rows)
    m = inv_projection.to(torch.float32)

    def mv(r):
        return m3.fma(m[r, 0], ndc_x, m[r, 1] * ndc_y) + (m[r, 2] * 0.5 + m[r, 3])

    p = torch.stack([mv(0), mv(1), mv(2)], -1)
    dir_vs = p / torch.clamp(-p[..., 2:3], min=1e-6)  # scaled so z = -1
    return dir_vs * linear_depth[..., None]


def _shift(img, axis: int, d: int):
    """img shifted by d along ``axis`` with clamp-to-edge:
    out[i] = img[clamp(i + d)]."""
    if d == 0:
        return img
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + d, 0, n - 1)
    return img.index_select(axis, idx)


def hbao(linear_depth, inv_projection, *, height: int, width: int, radius: float = 0.5,
         power: float = 1.5, bias: float = 0.1, num_samples: int = 4, row0=0,
         full_height: int | None = None, clamp_rows: bool = False):
    """Horizon-based ambient occlusion over the linear-depth buffer: 8
    screen directions, each marched at power-of-two pixel steps (2, 4, 8,
    16) tracking the largest horizon sine, attenuated by world distance.
    Returns (H, W) AO in [0, 1] (1 = unoccluded).

    Where a tap's shift clamps at the frame's edge its difference is 0
    here, as in the reference's function run op by op. The reference's
    compiled pass fuses one of the two products into each difference, so
    there the difference is a product's rounding error (~1e-7), which the
    horizon sine divides by at most 1e-6: it occludes some pixels within
    16 of the border that this pass leaves open (tests/test_torch_post.py
    measures how many)."""
    p = reconstruct_view_pos(linear_depth, inv_projection, height, width, row0, full_height,
                             clamp_rows)
    dzdx = _shift(p, 1, 1) - p
    dzdy = _shift(p, 0, 1) - p
    n = m3.normalize32(m3.cross32(dzdy, dzdx))
    n = torch.where(n[..., 2:3] < 0, -n, n)
    occlusion = torch.zeros(height, width, device=p.device)
    for d8 in _DIRS:
        max_sin = torch.zeros(height, width, device=p.device)
        for s in range(num_samples):
            step = 2 << s
            du = int(round(float(d8[0]) * step))
            dv = int(round(float(d8[1]) * step))
            diff = _shift(_shift(p, 0, dv), 1, du) - p
            dist = torch.sqrt(m3.dot32(diff, diff))
            sin_h = m3.dot32(diff, n) / torch.clamp(dist, min=1e-6)
            atten = torch.clamp(1.0 - dist / radius, 0.0, 1.0)
            max_sin = torch.maximum(max_sin, (sin_h - bias) * atten)
        occlusion = occlusion + torch.clamp(max_sin, 0.0, 1.0)
    ao = 1.0 - occlusion / len(_DIRS)
    return torch.clamp(ao, 0.0, 1.0) ** power


_HBAO_HALO = 17  # the march's longest vertical reach (16 rows) + the normal's row


def exchange_row_halo(img, r: int, comm):
    """One shard's rows with ``r`` rows of each neighbour above and below,
    (h + 2r, ...); the first and the last shard repeat their own edge row,
    as the whole frame's edge clamp does."""
    prev, nxt = comm.neighbour_rows(img[:r], img[-r:])
    if prev is None:
        prev = img[:1].expand((r,) + tuple(img.shape[1:]))
    if nxt is None:
        nxt = img[-1:].expand((r,) + tuple(img.shape[1:]))
    return torch.cat([prev, img, nxt], dim=0)


def hbao_sharded(linear_depth, inv_projection, *, height: int, width: int, radius: float,
                 power: float, comm, row0: int, full_height: int):
    """``hbao`` of one shard's row slice, equal to the whole frame's pass
    sliced: a 17-row halo from each neighbour, the pass over the extended
    window with its global rows clamped into the viewport, the centre
    cropped."""
    r = _HBAO_HALO
    ext = exchange_row_halo(linear_depth, r, comm)
    ao = hbao(ext, inv_projection, height=height + 2 * r, width=width, radius=radius,
              power=power, row0=row0 - r, full_height=full_height, clamp_rows=True)
    return ao[r:-r]


def _sample_shift(img, du, dv, height: int, width: int):
    """Bilinear fetch at per-pixel offsets (du, dv) in pixels."""
    ys = _arange(height, img.device)[:, None] + dv + 0.5
    xs = _arange(width, img.device)[None, :] + du + 0.5
    uv = torch.stack([torch.broadcast_to(xs, (height, width)) / width,
                      torch.broadcast_to(ys, (height, width)) / height], dim=-1)
    return sampling.sample_bilinear(img, uv)


def downsample_quarter(color):
    """4x box downsample (the motion blur's tap table)."""
    return window_sum(color, 4) * (1.0 / 16.0)


def motion_blur(color, depth_rev, prev_view_proj, inv_view_proj, *, intensity: float = 1.0,
                num_samples: int = 8, row0=0, full_height: int | None = None,
                quarter_full=None, comm=None):
    """Camera motion blur (MotionBlur.shader): each quarter-resolution
    pixel is unprojected from its reverse-Z depth, reprojected by the
    previous frame's view-projection, and the frame's quarter table is
    sampled (nearest) along the screen velocity; the sum is upsampled and
    averaged with the pixel's own colour. A row shard passes the whole
    frame's quarter table (``quarter_full``, gathered) and its
    communicator (``comm``) for the boundary-exact upsample."""
    h, w = color.shape[:2]
    fh = full_height if full_height is not None else h
    q = 4
    he, we = (h // q) * q, (w // q) * q
    dev = color.device
    u, v = _pixel_uv(_arange(he // q, dev, q), _arange(we // q, dev, q), w, fh, row0)
    depth_q = depth_rev[:he:q, :we:q]
    ndc = torch.stack([u * 2 - 1, 1 - 2 * v, torch.clamp(depth_q, min=1e-6),
                       torch.ones_like(u)], -1)
    world = m3.homogenize(torch.einsum("ij,hwj->hwi", inv_view_proj.to(torch.float32), ndc))
    prev_clip = m3.transform_point_h(prev_view_proj.to(torch.float32), world)
    prev_ndc = prev_clip[..., :2] / torch.clamp(prev_clip[..., 3:4].abs(), min=1e-6)
    prev_uv = torch.stack([prev_ndc[..., 0] * 0.5 + 0.5, 0.5 - prev_ndc[..., 1] * 0.5], -1)
    uv_h = torch.stack([u, v], -1)
    vel_h = (uv_h - prev_uv) * intensity
    quarter = quarter_full if quarter_full is not None else downsample_quarter(color)
    acc_h = torch.zeros(he // q, we // q, color.shape[-1], dtype=color.dtype, device=dev)
    for s in range(1, num_samples):
        acc_h = acc_h + sampling.sample_nearest(quarter, uv_h - vel_h * (s / num_samples))
    acc = sampling.upsample_bilinear_pow2_sharded(acc_h, (h, w), comm)
    return (color + acc) / num_samples


def _associative_scan_iir(a, b):
    """Inclusive scan along axis 1 of the first-order recurrence
    x[r] = a[r] * x[r - 1] + b[r], combined as (a1 a2, b1 a2 + b2), in the
    same odd/even recursion as ``jax.lax.associative_scan`` (so the
    products pair up as the reference's do)."""
    def combine(x, y):
        return x[0] * y[0], x[1] * y[0] + y[1]

    def scan(elems):
        n = elems[0].shape[1]
        if n < 2:
            return elems
        reduced = combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
        else:
            even = combine(odd, [e[:, 2::2] for e in elems])
        even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
        out = []
        for ev, od in zip(even, odd):  # interleave even and odd positions
            full = torch.empty((ev.shape[0], n) + tuple(ev.shape[2:]), dtype=ev.dtype,
                               device=ev.device)
            full[:, 0::2] = ev
            full[:, 1::2] = od
            out.append(full)
        return out

    return scan([a, b])


def sun_shafts(color, depth_rev, view_projection, sun_direction, sun_intensity, *,
               intensity: float = 0.45, num_samples: int = 24, row0=0,
               full_height: int | None = None, comm=None):
    """Screen-space god rays (SunShafts.shader): the quarter-resolution
    sky-visibility mask is resampled onto a polar grid about the sun's
    screen position, decayed along the radius by a first-order IIR, read
    back per pixel, softened by a 3x3 box and added as glow. A row shard
    (``comm``) gathers the whole frame's mask and upsamples
    boundary-exactly."""
    h, w = color.shape[:2]
    fh = full_height if full_height is not None else h
    dev = color.device
    vp = view_projection.to(torch.float32)
    to_sun = -torch.as_tensor(sun_direction, dtype=torch.float32, device=dev)
    clip = vp[:3, :3] @ to_sun
    wclip = vp[3, :3] @ to_sun
    behind = wclip <= 1e-4
    ndc = clip[:2] / torch.where(behind, torch.ones_like(wclip), wclip)
    uv_sun = torch.stack([ndc[0] * 0.5 + 0.5, 0.5 - ndc[1] * 0.5])
    border = 0.51  # fade out as the sun leaves the screen
    off = torch.clamp(torch.maximum(uv_sun - 1.0, -uv_sun), min=0.0).max()
    fade = torch.where(behind, torch.zeros_like(off),
                       torch.clamp(1.0 - off / border, 0.0, 1.0))

    q = 4
    he, we = (h // q) * q, (w // q) * q
    sky = (depth_rev[:he, :we] <= 0.0).to(torch.float32)
    mask = window_sum(sky, q) * (1.0 / (q * q))
    if comm is not None:
        mask = comm.all_gather(mask)
    uv0 = torch.stack(_pixel_uv(_arange(he // q, dev, q), _arange(we // q, dev, q), w, fh,
                                row0), -1)

    A, R = 384, max(64, num_samples * 8)
    corners = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], device=dev)
    rmax = torch.sqrt(((corners - uv_sun) ** 2).sum(-1)).max() + 1e-4
    ang = (torch.arange(A, dtype=torch.float32, device=dev) + 0.5) * (2.0 * math.pi / A)
    rad = (torch.arange(R, dtype=torch.float32, device=dev) + 0.5) * (rmax / R)
    dirs = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    uv_grid = uv_sun + dirs[:, None, :] * rad[None, :, None]
    polar = sampling.sample_nearest(mask[..., None], uv_grid)[..., 0]
    inside = ((uv_grid >= 0.0) & (uv_grid <= 1.0)).all(-1)
    polar = torch.where(inside, polar, torch.zeros_like(polar))

    d = 0.5 ** (4.0 / R)  # half-life of R/4 radial steps
    _, ema = _associative_scan_iir(torch.full_like(polar, d), polar)
    polar_shaft = ema * (1.0 - d)

    rel = uv0 - uv_sun
    r_pix = torch.sqrt((rel ** 2).sum(-1))
    a_pix = torch.remainder(torch.atan2(rel[..., 1], rel[..., 0]), 2.0 * math.pi)
    ia = torch.clamp((a_pix * (A / (2.0 * math.pi))).to(torch.int32), 0, A - 1)
    ir = torch.clamp((r_pix * (R / rmax)).to(torch.int32), 0, R - 1)
    shaft_q = polar_shaft.reshape(-1)[(ia * R + ir).long()]
    pad = torch.nn.functional.pad(shaft_q[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = pad[dy:dy + shaft_q.shape[0], dx:dx + shaft_q.shape[1]]
            acc = tap if acc is None else acc + tap
    shaft_q = acc / 9.0
    shaft = sampling.upsample_bilinear_pow2_sharded(shaft_q[..., None], (h, w), comm)[..., 0]
    return color + (shaft * fade * intensity)[..., None] * sun_intensity


def chromatic_aberration(color, strength: float = 0.003):
    """Radial RGB split (ChromaticAberation.shader): red sampled outward,
    blue inward, green in place."""
    h, w = color.shape[:2]
    uv = torch.stack(_pixel_uv(_arange(h, color.device), _arange(w, color.device), w, h), -1)
    off = (uv - 0.5) * strength
    r = sampling.sample_bilinear(color[..., 0:1], uv + off)[..., 0]
    b = sampling.sample_bilinear(color[..., 2:3], uv - off)[..., 0]
    return torch.stack([r, color[..., 1], b], dim=-1)
