"""Binned-SAH BVH build (host, numpy) and the binary traversal: copies of
``build`` and ``intersect`` from ``sailor_tpu/raytracing/bvh.py``.

The sweep intersector (``raytracing/sweep.py``) takes the build's leaf
order as its triangle order: consecutive runs of ``CLUSTER`` triangles make
its clusters, and the index of a triangle in that order breaks ties between
equal hit distances. So this copy repeats the reference's numpy calls one
for one and gives the same ``tri_index`` bit for bit; ``bvh8``'s numpy
builder collapses it. ``intersect`` is the reference's binary traversal,
which only the tests call: plain PyTorch on either device (no kernel), a
host-driven lockstep loop with one ``.any()`` read per iteration.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3

MAX_STACK = 48
LEAF_SIZE = 4
SAH_BINS = 16


@dataclasses.dataclass
class BVH:
    """Flat BVH. Internal node i has children (left[i], left[i]+1); leaf
    iff count[i] > 0, holding triangles [start[i], start[i]+count[i]) of the
    reordered triangle arrays."""

    node_min: np.ndarray    # (N, 3)
    node_max: np.ndarray    # (N, 3)
    node_left: np.ndarray   # (N,) int32
    node_start: np.ndarray  # (N,) int32
    node_count: np.ndarray  # (N,) int32 (0 = internal)
    v0: np.ndarray          # (T, 3) reordered triangle vertices
    v1: np.ndarray
    v2: np.ndarray
    tri_index: np.ndarray   # (T,) original triangle ids


def _area(lo, hi):
    d = np.maximum(hi - lo, 0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVH:
    """Binned-SAH top-down build over a triangle soup."""
    t = len(v0)
    cent = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)

    order = np.arange(t, dtype=np.int32)
    cap = max(2 * t, 2)
    nmin = np.zeros((cap, 3), np.float32)
    nmax = np.zeros((cap, 3), np.float32)
    nleft = np.zeros(cap, np.int32)
    nstart = np.zeros(cap, np.int32)
    ncount = np.zeros(cap, np.int32)
    n_nodes = 1

    stack = [(0, 0, t)]  # (node, start, end) over `order`
    while stack:
        node, start, end = stack.pop()
        ids = order[start:end]
        nmin[node] = tmin[ids].min(axis=0)
        nmax[node] = tmax[ids].max(axis=0)
        count = end - start
        if count <= LEAF_SIZE:
            nstart[node] = start
            ncount[node] = count
            continue

        # binned SAH over the largest centroid axis
        c = cent[ids]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        if cmax[axis] - cmin[axis] < 1e-12:
            mid = start + count // 2  # degenerate spread: median split
        else:
            scale = SAH_BINS * (1.0 - 1e-6) / (cmax[axis] - cmin[axis])
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bin_count = np.bincount(bins, minlength=SAH_BINS)
            bin_min = np.full((SAH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((SAH_BINS, 3), -np.inf, np.float32)
            for b in range(SAH_BINS):
                m = bins == b
                if m.any():
                    bin_min[b] = tmin[ids[m]].min(axis=0)
                    bin_max[b] = tmax[ids[m]].max(axis=0)
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_count)
            rcnt = np.cumsum(bin_count[::-1])[::-1]
            # split after bin s: left = bins[0..s], right = bins[s+1..]
            cost = (_area(lmin[:-1], lmax[:-1]) * lcnt[:-1]
                    + _area(rmin[1:], rmax[1:]) * rcnt[1:])
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            s = int(np.argmin(cost))
            if not np.isfinite(cost[s]):
                mid = start + count // 2
            else:
                sel = bins <= s
                left_ids = ids[sel]
                right_ids = ids[~sel]
                order[start:start + len(left_ids)] = left_ids
                order[start + len(left_ids):end] = right_ids
                mid = start + len(left_ids)

        if mid == start or mid == end:
            mid = start + count // 2
            # median partition on the axis for robustness
            part = np.argsort(cent[order[start:end], axis], kind="stable")
            order[start:end] = order[start:end][part]

        left = n_nodes
        n_nodes += 2
        nleft[node] = left
        stack.append((left, start, mid))
        stack.append((left + 1, mid, end))

    return BVH(node_min=nmin[:n_nodes], node_max=nmax[:n_nodes],
               node_left=nleft[:n_nodes], node_start=nstart[:n_nodes],
               node_count=ncount[:n_nodes], v0=v0[order], v1=v1[order],
               v2=v2[order], tri_index=order)


# ---------------------------------------------------------------- traversal

def _ray_aabb_t(omin, omax, origin, inv_dir, t_max):
    """Slab test: (hit, entry) of each ray against its (R, 3) box."""
    t0 = (omin - origin) * inv_dir
    t1 = (omax - origin) * inv_dir
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    return (tfar >= torch.clamp_min(tnear, 0.0)) & (tnear < t_max), tnear


def _tri_hit(origin, direction, a, b, c, eps=1e-7):
    """Moller-Trumbore as the reference's compiled loop rounds it: the
    crosses and dots fused (``math3d.cross``, ``math3d.dot``)."""
    e1 = b - a
    e2 = c - a
    p = m3.cross(direction, e2)
    det = m3.dot(e1, p)
    inv = torch.where(det.abs() > eps, 1.0 / det, 0.0)
    s = origin - a
    u = m3.dot(s, p) * inv
    q = m3.cross(s, e1)
    v = m3.dot(direction, q) * inv
    t = m3.dot(e2, q) * inv
    hit = (det.abs() > eps) & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 1e-4)
    return t, u, v, hit


def intersect(bvh: BVH, origin, direction, t_max=math.inf, *, any_hit: bool = False):
    """Closest (or any) hit of (R, 3) rays by the binary BVH, nearer child
    first: dict(t, tri (the REORDERED triangle index, -1 = miss), u, v,
    hit), as the reference's. Gathers clamp their indices as XLA's do; a
    push past ``MAX_STACK`` is lost, as in the reference."""
    dev = origin.device

    def arr(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    nmin, nmax, v0, v1, v2 = (arr(x) for x in (bvh.node_min, bvh.node_max, bvh.v0, bvh.v1,
                                                bvh.v2))
    nleft, nstart, ncount = (arr(x).long() for x in (bvh.node_left, bvh.node_start,
                                                     bvh.node_count))
    last_node, last_tri = len(ncount) - 1, len(v0) - 1
    r = origin.shape[0]
    inv_dir = torch.where(direction.abs() > 1e-12, 1.0 / direction, 1e12)
    t_best = torch.full((r,), float(t_max), device=dev)
    tri_best = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u_best, v_best = torch.zeros(r, device=dev), torch.zeros(r, device=dev)
    stack = torch.zeros(r, MAX_STACK, dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    live = torch.ones(r, dtype=torch.bool, device=dev)
    lanes = torch.arange(r, device=dev)
    while bool(live.any()):
        count = ncount[node]
        is_leaf = count > 0
        start = nstart[node]
        for k in range(LEAF_SIZE):
            idx = start + k
            at = idx.clamp(max=last_tri)
            t, u, v, hit = _tri_hit(origin, direction, v0[at], v1[at], v2[at])
            take = (k < count) & is_leaf & live & hit & (t < t_best)
            t_best = torch.where(take, t, t_best)
            tri_best = torch.where(take, idx, tri_best)
            u_best = torch.where(take, u, u_best)
            v_best = torch.where(take, v, v_best)
        left = nleft[node].clamp(max=last_node)
        right = (nleft[node] + 1).clamp(max=last_node)
        lhit, lt = _ray_aabb_t(nmin[left], nmax[left], origin, inv_dir, t_best)
        rhit, rt = _ray_aabb_t(nmin[right], nmax[right], origin, inv_dir, t_best)
        lhit = lhit & ~is_leaf & live
        rhit = rhit & ~is_leaf & live
        near_is_left = lt <= rt
        near = torch.where(near_is_left, left, right)
        far = torch.where(near_is_left, right, left)
        near_hit = torch.where(near_is_left, lhit, rhit)
        far_hit = torch.where(near_is_left, rhit, lhit)
        push = near_hit & far_hit
        fits = push & (sp < MAX_STACK)
        stack[lanes[fits], sp[fits]] = far[fits]
        sp = sp + push.long()
        descend = near_hit | far_hit
        pop = ~descend & live
        sp_pop = (sp - 1).clamp(0, MAX_STACK - 1)
        popped = stack[lanes, sp_pop]
        empty = sp == 0
        node = torch.where(descend, torch.where(near_hit, near, far),
                           torch.where(empty, 0, popped))
        sp = torch.where(pop, (sp - 1).clamp(min=0), sp)
        live = live & ~(pop & empty)
        if any_hit:
            live = live & (tri_best < 0)
    tri = tri_best.to(torch.int32)
    return {"t": t_best, "tri": tri, "u": u_best, "v": v_best, "hit": tri >= 0}
