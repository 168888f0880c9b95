"""A plain visibility raster: depth and source triangle of every pixel,
from the scene's host arrays and the camera alone.

Vertices go to clip space by proj @ view; triangles that cross the near
plane (w = z_near) are clipped into at most two; back faces (clockwise on
screen, y down) are dropped, except in the two-sided transparent peel;
each pixel centre that the triangle covers (the renderer's rule: within
0.05 pixel outside its edges and its screen box at most) takes its
screen-linear reverse-Z depth, and the largest depth wins (ties: the
lower triangle).

The Opaque queue rasters first. The Masked queue is then peeled as the
renderer's depth prepass defines it, ``masked_layers`` layers deep: each
layer is the nearest masked fragment in front of the depth so far and
behind the last layer peeled; its alpha (the albedo map's alpha times
the vertex colour's, at the uv of the pixel ray's barycentrics on the
triangle, clamped into it) is tested against the material's cutoff, and
a pixel whose layer fails peels on. The alpha is read as the renderer's
texture format and sampler define it: the map's box-filtered mip chain
stored as 8-bit sRGB-encoded texels, the mip nearest the level of detail
of each aligned 2x2 pixel quad's uv differences (background partners
dropped), bilinear there with repeat addressing.

The Transparent queue is peeled two-sided, ``transparent_layers`` deep,
in front of the opaque and masked depth, with no alpha test.

Plain PyTorch in the given dtype (float32 for the check; a lower one is
the control). Also gives each triangle's pixel pairs (the AABB area on
screen) for the raster's bound.
"""

from __future__ import annotations

import numpy as np
import torch

PAIRS_PER_CHUNK = 1 << 23
# the renderer's coverage rule: a pixel centre is covered where its signed
# distance to each edge, and to the triangle's screen box, is at least
# -EDGE_MARGIN pixels (so shared edges leave no cracks); triangles of less
# than MIN_AREA twice-area in pixels are dropped
EDGE_MARGIN = 0.05
MIN_AREA = 1e-10


def _clip_near(tri_clip: np.ndarray, w_near: float):
    """Sutherland-Hodgman against w >= w_near for (T, 3, 4) rows of clip
    xyzw: returns (rows (T', 3, 4), source index (T',))."""
    inside = tri_clip[:, :, 3] >= w_near
    keep = inside.all(1)
    out, src = [tri_clip[keep]], [np.nonzero(keep)[0]]
    for t in np.nonzero(inside.any(1) & ~keep)[0]:
        poly = []
        v = tri_clip[t]
        for i in range(3):
            a, b = v[i], v[(i + 1) % 3]
            ia, ib = a[3] >= w_near, b[3] >= w_near
            if ia:
                poly.append(a)
            if ia != ib:
                s = (w_near - a[3]) / (b[3] - a[3])
                poly.append(a + s * (b - a))
        for k in range(1, len(poly) - 1):
            out.append(np.stack([poly[0], poly[k], poly[k + 1]])[None])
            src.append(np.array([t]))
    return np.concatenate(out), np.concatenate(src)


def setup(h: dict, queues: tuple, cull_back: bool = True, dtype=torch.float32,
          device="cpu"):
    """Screen-space triangles of the material queues ``queues``: a dict of
    device tensors (x, y, depth (T, 3), source id, material id, twice the
    signed area, depth-plane rounding scale)."""
    s = h["soup"]
    q = np.asarray(h["materials"]["queue"])[s["material_id"]]
    ids = np.nonzero(np.isin(q, queues))[0]
    idx = s["indices"][ids]
    vp = (h["proj"].astype(np.float64) @ h["view"].astype(np.float64)).astype(np.float32)
    pos = torch.from_numpy(s["position"]).to(device, dtype)
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], 1) @ torch.from_numpy(vp).to(
        device, dtype).T
    rows = clip.float().cpu().numpy()[idx]
    rows, src = _clip_near(rows, float(h["z_near"]))
    r = torch.from_numpy(rows).to(device, dtype)
    w = r[..., 3]
    x = (r[..., 0] / w * 0.5 + 0.5) * h["width"]
    y = (0.5 - r[..., 1] / w * 0.5) * h["height"]
    z = r[..., 2] / w
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0])
    keep = (area < 0 if cull_back else area != 0) & (area.abs() >= MIN_AREA)
    src_t = torch.from_numpy(ids[src]).to(device)
    # the float32 rounding scale of a depth plane solved at absolute screen
    # coordinates: 2^-24 |x|max |y|max z_max / |twice the area|
    xf, yf, zf = x.float(), y.float(), z.float()
    cond = (2.0 ** -24 * (xf.abs().amax(1) + 1) * (yf.abs().amax(1) + 1) * zf.abs().amax(1)
            / area.float().abs().clamp(min=MIN_AREA))
    return {"cond": cond[keep], "x": x[keep], "y": y[keep], "z": z[keep], "src": src_t[keep],
            "mat": torch.from_numpy(s["material_id"]).to(device)[src_t[keep]],
            "area": area[keep]}


def pixel_boxes(t: dict, width: int, height: int, margin: float = 0.0):
    """Each triangle's pixel-centre AABB on screen, grown by ``margin``
    pixels on every side: (x0, x1, y0, y1), empty where x1 < x0 or
    y1 < y0."""
    x0 = torch.clamp(torch.ceil(t["x"].amin(1).float() - margin - 0.5), min=0).long()
    x1 = torch.clamp(torch.floor(t["x"].amax(1).float() + margin - 0.5), max=width - 1).long()
    y0 = torch.clamp(torch.ceil(t["y"].amin(1).float() - margin - 0.5), min=0).long()
    y1 = torch.clamp(torch.floor(t["y"].amax(1).float() + margin - 0.5), max=height - 1).long()
    return x0, x1, y0, y1


def aabb_pairs(t: dict, width: int, height: int) -> int:
    """(pixel, triangle) pairs inside the triangles' screen AABBs."""
    x0, x1, y0, y1 = pixel_boxes(t, width, height)
    return int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)).sum())




MIN_MIP = 4  # the coarsest mip edge of the renderer's texture format


def _fragments(t: dict, width: int, height: int, dtype, device):
    """Every (pixel, triangle) fragment whose pixel centre the triangle
    covers, with depth in (0, 1]: pixel index, depth, triangle (row of
    ``t``) and the triangle's depth-plane rounding scale."""
    x0, x1, y0, y1 = pixel_boxes(t, width, height, EDGE_MARGIN)
    nx, ny = (x1 - x0 + 1).clamp(min=0), (y1 - y0 + 1).clamp(min=0)
    n = nx * ny
    ends = torch.cumsum(n, 0)
    lo_x, hi_x = t["x"].amin(1) - EDGE_MARGIN, t["x"].amax(1) + EDGE_MARGIN
    lo_y, hi_y = t["y"].amin(1) - EDGE_MARGIN, t["y"].amax(1) + EDGE_MARGIN
    parts = []
    start = 0
    while start < n.numel():
        base = int(ends[start - 1]) if start else 0
        stop = max(int(torch.searchsorted(ends, base + PAIRS_PER_CHUNK, right=True)),
                   start + 1)
        cnt = n[start:stop]
        tri = torch.repeat_interleave(torch.arange(start, stop, device=device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(tri.numel(), device=device) - first[tri - start]
        px = x0[tri] + k % nx[tri]
        py = y0[tri] + k // nx[tri]
        cx, cy = (px.to(dtype) + 0.5), (py.to(dtype) + 0.5)
        xs, ys = t["x"][tri], t["y"][tri]
        area = t["area"][tri]
        e = []
        inside = ((cx >= lo_x[tri]) & (cx <= hi_x[tri]) & (cy >= lo_y[tri])
                  & (cy <= hi_y[tri]))
        for i in range(3):
            a, b = (i + 1) % 3, (i + 2) % 3
            ex, ey = xs[:, b] - xs[:, a], ys[:, b] - ys[:, a]
            e.append(ex * (cy - ys[:, a]) - ey * (cx - xs[:, a]))
            dist = e[-1] * torch.sign(area) / torch.sqrt(ex * ex + ey * ey)
            inside &= dist >= -EDGE_MARGIN
        b = [ei / area for ei in e]
        depth = b[0] * t["z"][tri, 0] + b[1] * t["z"][tri, 1] + b[2] * t["z"][tri, 2]
        inside &= (depth > 0) & (depth <= 1)
        parts.append(((py * width + px)[inside], depth[inside], tri[inside],
                      t["cond"][tri][inside]))
        start = stop
    if not parts:
        e = torch.zeros(0, device=device)
        return {"pix": e.long(), "depth": e.to(dtype), "tri": e.long(), "cond": e.float()}
    cols = list(zip(*parts))
    return {k: torch.cat(c) for k, c in zip(("pix", "depth", "tri", "cond"), cols)}


def _nearest(f: dict, sel, npix: int):
    """The winner of each pixel among the fragments ``sel``: (hit (P,),
    index of the winning fragment (P,), any value where no hit)."""
    dbits = f["depth"].float().contiguous().view(torch.int32).to(torch.int64)
    key = (dbits << 32) | (0x7FFFFFFF - f["tri"])
    best = torch.full((npix,), -1, dtype=torch.int64, device=key.device)
    best.scatter_reduce_(0, f["pix"][sel], key[sel], reduce="amax")
    win = torch.zeros(npix, dtype=torch.int64, device=key.device)
    at = torch.nonzero(sel & (key == best[f["pix"]]))[:, 0]
    win[f["pix"][at]] = at
    return best >= 0, win


def screen_lod(uv, base_size: int, valid):
    """Level of detail of each pixel from its aligned 2x2 quad's uv
    differences (one pair a quad for each axis, wrapped to [-0.5, 0.5)),
    in texels of the base level; a difference with a background partner
    is dropped. An odd last row or column takes its neighbour's level."""
    h, w = uv.shape[:2]
    he, we = h - (h % 2), w - (w % 2)
    uq, vq = uv[:he, :we], valid[:he, :we]
    dx = (uq[:, 1::2] - uq[:, ::2]).repeat_interleave(2, dim=1)
    dy = (uq[1::2] - uq[::2]).repeat_interleave(2, dim=0)
    dx, dy = dx - torch.round(dx), dy - torch.round(dy)
    rx = torch.where((vq[:, 1::2] & vq[:, ::2]).repeat_interleave(2, dim=1),
                     (dx * dx).sum(-1), 0.0)
    ry = torch.where((vq[1::2] & vq[::2]).repeat_interleave(2, dim=0), (dy * dy).sum(-1), 0.0)
    rho = torch.maximum(rx, ry) * float(base_size * base_size)
    lod = 0.5 * torch.log2(torch.clamp(rho.float(), min=1e-12))
    if (he, we) != (h, w):
        lod = torch.nn.functional.pad(lod[None, None], (0, w - we, 0, h - he),
                                      mode="replicate")[0, 0]
    return lod


def alpha_levels(alpha: np.ndarray, dtype, device) -> list:
    """The alpha of one map as the texture format stores it, level by
    level: box-filtered halvings down to ``MIN_MIP``, each texel clipped
    to [0, 1], sRGB-encoded (1/2.2 power) into 8 bits and decoded back."""
    cur = torch.from_numpy(np.ascontiguousarray(alpha, np.float32))
    out = []
    while True:
        q = torch.round(torch.clamp(cur, 0.0, 1.0) ** (1.0 / 2.2) * 255.0)
        out.append(((q * (1.0 / 255.0)) ** 2.2).to(device, dtype))
        s = cur.shape[0]
        if s <= MIN_MIP or s // 2 < MIN_MIP:
            return out
        cur = cur.reshape(s // 2, 2, s // 2, 2).mean(dim=(1, 3))


def _bilinear(img, uv):
    """Bilinear fetch of an (S, S) level at ``uv`` (..., 2), repeat
    addressing."""
    s = img.shape[0]
    fx, fy = uv[..., 0] * s - 0.5, uv[..., 1] * s - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0f, fy - y0f
    x0, y0 = x0f.long() % s, y0f.long() % s
    x1, y1 = (x0 + 1) % s, (y0 + 1) % s
    return (img[y0, x0] * ((1 - tx) * (1 - ty)) + img[y0, x1] * (tx * (1 - ty))
            + img[y1, x0] * ((1 - tx) * ty) + img[y1, x1] * (tx * ty))


def _alpha(h: dict, mat, uv, lod, dtype, device):
    """Albedo alpha of material ``mat`` at ``uv`` on the mip nearest
    ``lod`` (1 where the material has no albedo map)."""
    mats = h["materials"]
    layer = torch.from_numpy(np.asarray(mats["albedo_texture"])).to(device)[mat]
    out = torch.ones(mat.shape, dtype=dtype, device=device)
    for li in torch.unique(layer).tolist():
        if li < 0:
            continue
        levels = alpha_levels(np.asarray(h["images"][li])[..., 3], dtype, device)
        lvl = torch.round(torch.clamp(lod, 0.0, len(levels) - 1.0)).long()
        for k, img in enumerate(levels):
            sel = (layer == li) & (lvl == k)
            if bool(sel.any()):
                out[sel] = _bilinear(img, uv[sel]).to(dtype)
    return out


def pixel_rays(h: dict, dtype, device):
    """The camera position and the direction of the ray through each pixel
    centre (H * W, 3), from the inverse of proj @ view."""
    width, height = h["width"], h["height"]
    vp = h["proj"].astype(np.float64) @ h["view"].astype(np.float64)
    inv_vp = torch.from_numpy(np.linalg.inv(vp).astype(np.float32)).to(device, dtype)
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=dtype) + 0.5,
                            torch.arange(width, device=device, dtype=dtype) + 0.5,
                            indexing="ij")
    ndc = torch.stack([xs / width * 2 - 1, 1 - ys / height * 2, torch.ones_like(xs),
                       torch.ones_like(xs)], -1)
    near = ndc @ inv_vp.T
    cam = torch.from_numpy(h["eye"]).to(device, dtype)
    return cam, (near[..., :3] / near[..., 3:4] - cam).reshape(-1, 3)


def _corners(h: dict, name: str, src, dtype, device):
    soup = h["soup"]
    a = torch.from_numpy(np.ascontiguousarray(soup[name][soup["indices"]])).to(device, dtype)
    return a[src.clamp(min=0)]


def barycentrics(h: dict, src, rays, cam, dtype, device):
    """(u, v) where each ray from ``cam`` meets the plane of source triangle
    ``src`` (Moller-Trumbore), clamped into the triangle as the renderer's
    resolve clamps them: u to [0, 1], then v to [0, 1 - u]. So a pixel that
    the coverage margin admits takes the attributes of the triangle's
    nearest edge point along u, v."""
    p = _corners(h, "position", src, dtype, device)
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    pv = torch.linalg.cross(rays, e2, dim=-1)
    det = (e1 * pv).sum(-1)
    inv = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tv = cam - p[:, 0]
    u = (tv * pv).sum(-1) * inv
    v = (rays * torch.linalg.cross(tv, e1, dim=-1)).sum(-1) * inv
    u = torch.clamp(u, 0.0, 1.0)
    return u, torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)


def attribute(h: dict, name: str, src, u, v, dtype, device):
    """The soup's vertex attribute ``name`` of triangle ``src`` at (u, v)."""
    a = _corners(h, name, src, dtype, device)
    return a[:, 0] + (a[:, 1] - a[:, 0]) * u[:, None] + (a[:, 2] - a[:, 0]) * v[:, None]


def position(h: dict, src, dtype=torch.float32, device="cpu"):
    """World position of each pixel (H, W, 3) on source triangle ``src``
    (H, W) at the clamped barycentrics of its pixel ray (any where ``src``
    is -1)."""
    cam, rays = pixel_rays(h, dtype, device)
    s = src.reshape(-1)
    u, v = barycentrics(h, s, rays, cam, dtype, device)
    return attribute(h, "position", s, u, v, dtype, device).reshape(src.shape + (3,))


def _queue_fragments(h, queue, cull_back, dtype, device):
    t = setup(h, (queue,), cull_back, dtype, device)
    return t, _fragments(t, h["width"], h["height"], dtype, device)


def rasterize(h: dict, dtype=torch.float32, device="cpu", masked_layers: int = 3):
    """(depth (H, W), source triangle id (H, W), -1 where nothing, the
    winner's depth-plane rounding scale (H, W)) of the Opaque queue and the
    Masked queue's peel."""
    width, height = h["width"], h["height"]
    npix = width * height
    t, f = _queue_fragments(h, 0, True, dtype, device)
    depth = torch.zeros(npix, dtype=dtype, device=device)
    src = torch.full((npix,), -1, dtype=torch.int64, device=device)
    cond = torch.zeros(npix, device=device)
    if f["pix"].numel():
        hit, win = _nearest(f, torch.ones_like(f["pix"], dtype=torch.bool), npix)
        depth = torch.where(hit, f["depth"][win], depth)
        src = torch.where(hit, t["src"][f["tri"][win]], src)
        cond = torch.where(hit, f["cond"][win], cond)
    mats = h["materials"]
    t, f = _queue_fragments(h, 1, True, dtype, device)
    if masked_layers and f["pix"].numel():
        cutoff = torch.from_numpy(np.asarray(mats["alpha_cutoff"], np.float32)).to(device,
                                                                                  dtype)
        zhi = torch.full((npix,), 2.0, dtype=dtype, device=device)
        undecided = torch.ones(npix, dtype=torch.bool, device=device)
        cam, rays = pixel_rays(h, dtype, device)
        for _ in range(masked_layers):
            sel = (f["depth"] > depth[f["pix"]]) & (f["depth"] < zhi[f["pix"]])
            hit, win = _nearest(f, sel, npix)
            tsrc = torch.where(hit, t["src"][f["tri"][win]], -1)
            u, v = barycentrics(h, tsrc, rays, cam, dtype, device)
            uv = torch.where(hit[:, None], attribute(h, "uv", tsrc, u, v, dtype, device), 0.0)
            lod = screen_lod(uv.reshape(height, width, 2), h["texture_size"],
                             hit.reshape(height, width)).reshape(-1)
            mat = t["mat"][f["tri"][win]]
            alpha = (_alpha(h, mat, uv, lod, dtype, device)
                     * attribute(h, "color", tsrc, u, v, dtype, device)[:, 3])
            passed = hit & (alpha >= cutoff[mat]) & undecided
            depth = torch.where(passed, f["depth"][win], depth)
            src = torch.where(passed, t["src"][f["tri"][win]], src)
            cond = torch.where(passed, f["cond"][win], cond)
            zhi = torch.where(hit, f["depth"][win], torch.zeros((), dtype=dtype, device=device))
            undecided &= hit & ~passed
    return depth.reshape(height, width), src.reshape(height, width), cond.reshape(height, width)


def transparent_layers(h: dict, depth, layers: int, dtype=torch.float32, device="cpu"):
    """The two-sided peel of the Transparent queue in front of ``depth``
    (H, W): for each of ``layers`` layers, nearest first, (source triangle
    id (H, W), -1 where the layer has nothing; the winner's depth-plane
    rounding scale over its depth (H, W))."""
    width, height = h["width"], h["height"]
    npix = width * height
    t, f = _queue_fragments(h, 2, False, dtype, device)
    if not f["pix"].numel():
        return [(torch.full((height, width), -1, dtype=torch.int64, device=device),
                 torch.zeros((height, width), device=device))] * layers
    zlo = depth.reshape(-1).to(dtype)
    zhi = torch.full((npix,), 2.0, dtype=dtype, device=device)
    out = []
    for _ in range(layers):
        sel = (f["depth"] > zlo[f["pix"]]) & (f["depth"] < zhi[f["pix"]])
        hit, win = _nearest(f, sel, npix)
        rel = f["cond"][win] / f["depth"][win].float()
        out.append((torch.where(hit, t["src"][f["tri"][win]], -1).reshape(height, width),
                    torch.where(hit, rel, 0.0).reshape(height, width)))
        zhi = torch.where(hit, f["depth"][win], torch.zeros((), dtype=dtype, device=device))
    return out
