"""Binned-SAH BVH build (host, numpy): a copy of ``build`` from
``sailor_tpu/raytracing/bvh.py``.

The sweep intersector (``raytracing/sweep.py``) takes the build's leaf
order as its triangle order: consecutive runs of ``CLUSTER`` triangles make
its clusters, and the index of a triangle in that order breaks ties between
equal hit distances. So this copy repeats the reference's numpy calls one
for one and gives the same ``tri_index`` bit for bit. The device traversal
of the reference (``intersect``) is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
