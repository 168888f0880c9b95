"""Cluster sweep intersector (counterpart of sailor_tpu/raytracing/sweep.py).

Triangles are sorted into spatial clusters of ``cluster`` triangles each
(``build(cluster=)``, by default ``CLUSTER``: ``SAILOR_SWEEP_CLUSTER`` read
at import, 256 without it, as the reference reads it; the BVH leaf order of
``raytracing/bvh.py``) and re-expressed so that every per-(ray,
triangle) quantity is a short dot product with the ray's features:

- Plücker side tests: a ray (o, d) has line coordinates (d, m = o x d), the
  edge A -> B has (A x B, B - A); the signed side is
  s = d . (A x B) + m . (B - A). The triangle is hit iff its three sides
  share a sign (two-sided test).
- Depth: t = (k - n . o) / (n . d) with n = e1 x e2 and k = n . v0.

``intersect`` runs two kernels:

- B4, the slab entry with the visit tables (``visit_tables``;
  ``csrc/slab_entry.cu``): per ``SUB``-ray sub-block, the least slab entry
  distance of its rays into each cluster's AABB (+inf where none pierces
  it), and the rays' feature rows and, per ``RAY_BLOCK``-ray block, the
  visit order and the tables the sweeps read, in one launch;
- with ``DMA_SWEEP`` on (the default; ``SAILOR_SWEEP_DMA=0`` turns it off,
  read at import as the reference reads it) B5, the cluster sweep
  (``sweep``; ``csrc/sweep.cu``): each sub-block walks
  the clusters of its ray block near to far (the stable argsort of the
  block's entries), skips a step whose sub-block entry is not below the
  sub-block's bound (the largest best t of its rays, compared as float32
  bits: dead rays hold -1.0, whose bits are negative), stops once the
  sorted block entry of the step reaches the bound, and tests every
  (ray, triangle) pair of a live step. Closest hit keeps the least t, equal
  t within a cluster going to the larger ``cid * cluster + col`` and across
  clusters to the earlier-visited one; any hit retires the ray with
  t = -1 and index 0;
- with it off B6, the same function over the dense (block, step) grid
  (``sweep_grid``; ``csrc/sweep_grid.cu``): each sub-block visits all the
  steps of its block's visit order and skips the dead ones, with no stop.

Each kernel has a plain PyTorch twin here (``visit_tables_plain``,
``sweep_plain``, ``sweep_grid_plain``) that evaluates the same float32
operations in the same order; the wrappers take the twin only for tensors
on the CPU. The winners' t/u/v are refined by one Moller-Trumbore test on
the winner rows (``_refine``, plain PyTorch). ``intersect(sort_rays=True)``
first sorts the rays by the first cluster they enter and a direction code
(plain PyTorch). A scene's cluster size is ``SweepScene.cluster``, the last
axis of its ``g_cluster``; the kernels take it at run time. So do they take
the ray block and sub-block sizes, ``RAY_BLOCK`` and ``SUB``
(``SAILOR_SWEEP_RAY_BLOCK`` and ``SAILOR_SWEEP_SUB``, read at import as the
reference reads them, 2048 and 256 without them): every function reads the
module's two at call time, so a caller may set them, and ``check_ray_block``
refuses a pair where ``SUB`` does not divide ``RAY_BLOCK``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.raytracing import bvh

# triangles a cluster: build()'s default, read once at import as the
# reference reads it (tools/time_sweep.py documents the knob)
CLUSTER = int(os.environ.get("SAILOR_SWEEP_CLUSTER", "256"))
# rays a ray block (the unit of the visit order) and a sub-block (the unit
# of the skip and stop decisions), read once at import as the reference
# reads them; check_ray_block says which pairs the sweep takes
RAY_BLOCK = int(os.environ.get("SAILOR_SWEEP_RAY_BLOCK", "2048"))
SUB = int(os.environ.get("SAILOR_SWEEP_SUB", "256"))
FEATS = 16   # ray feature columns: [d, m, 0, 0 | o, 1, d, 0]
ROWS = 40    # cluster feature rows, see SweepScene
USED_ROWS = 25  # rows B5 reads: 18 side, 4 num, 3 den
# (ray, triangle) pairs the sweep twins test at a time: 128 sub-blocks of
# 256 rays at 256 a cluster
_PLAIN_PAIRS = 128 * 256 * 256
# B4 keeps its per-block tables in shared memory while they fit in this
# many bytes (204 KB of the H100's 227 KB a block) and in a global scratch
# the wrapper allocates beyond (slab_smem_clusters: the one place that
# decides; csrc/slab_entry.cu follows the scratch pointer it is given)
SLAB_SMEM_BYTES = 208896
# B5's per-block walk (on) or B6's dense grid (off), as the reference reads it
DMA_SWEEP = os.environ.get("SAILOR_SWEEP_DMA", "1") == "1"
# The reference's routing rule, not a limit of the card: its sweep keeps the
# per-(sub-block, cluster) entry table in the TPU's scalar memory, and the
# path tracer leaves the sweep for the BVH8 traversal when that table
# (``scalar_bytes``) outgrows SMEM_BUDGET, read from SAILOR_SWEEP_SMEM as the
# reference reads it (1 MiB by default). The port routes by the same rule so
# that every pass takes the reference's intersector.
SMEM_BUDGET = int(os.environ.get("SAILOR_SWEEP_SMEM", str(1 << 20)))


def check_ray_block() -> tuple[int, int]:
    """(RAY_BLOCK, SUB) as the module holds them now, or ValueError for a
    pair the sweep cannot take: either below 1, or SUB not dividing
    RAY_BLOCK (the reference raises TypeError at such a pair, from a
    reshape)."""
    rb, sub = RAY_BLOCK, SUB
    if int(rb) != rb or int(sub) != sub or rb < 1 or sub < 1 or rb % sub:
        raise ValueError(f"SAILOR_SWEEP_RAY_BLOCK={rb!r} and SAILOR_SWEEP_SUB={sub!r}: both "
                         "must be integers of at least 1, and SAILOR_SWEEP_SUB must divide "
                         "SAILOR_SWEEP_RAY_BLOCK")
    return int(rb), int(sub)


def slab_smem_clusters() -> int:
    """The most clusters whose B4 tables fit SLAB_SMEM_BYTES of shared
    memory at this ray block: 32 B of box and 4 * (RAY_BLOCK/SUB + 1) B of
    entries a cluster (3,072 at the default 2048/256)."""
    rb, sub = check_ray_block()
    return SLAB_SMEM_BYTES // (32 + 4 * (rb // sub + 1))


def scalar_bytes(scene: "SweepScene", num_rays: int) -> int:
    """Bytes of the reference's scalar entry table for ``num_rays`` rays:
    4 * (sub-blocks + blocks) * clusters over the rays padded to whole
    ray blocks."""
    rb, sub = check_ray_block()
    nb = -(-max(num_rays, rb) // rb)
    return 4 * (nb * (rb // sub) + nb) * scene.n_clusters


@dataclasses.dataclass
class SweepScene:
    # (C, 40, cluster) float32 per-cluster features of the triangles in BVH
    # leaf order: rows 8e..8e+5 = [A x B, B - A] of edge e (A->B, B->C,
    # C->A), rows 24:27 = -n, row 27 = k, rows 36:39 = n; other rows zero.
    # Padding triangles are all zero, so their n . d = 0 rejects them.
    g_cluster: torch.Tensor
    v0e1e2: torch.Tensor   # (Tp, 9) [v0, e1, e2] for the exact refinement
    tri_id: torch.Tensor   # (Tp,) int32 original triangle id, -1 padding
    cl_min: torch.Tensor   # (C, 3) cluster AABB
    cl_max: torch.Tensor   # (C, 3)
    num_tris: int
    n_clusters: int
    cluster: int = CLUSTER  # triangles a cluster: g_cluster.shape[2]


def check_cluster(cluster: int) -> int:
    """``cluster`` as an int, or ValueError for a size the kernels cannot
    take: below 1 (no triangle a cluster)."""
    if int(cluster) != cluster or cluster < 1:
        raise ValueError(f"sweep cluster size {cluster!r}: must be an integer of at least 1")
    return int(cluster)


def build_arrays(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, *,
                 cluster: int = CLUSTER) -> dict:
    """Cluster and featurise a triangle soup (host, numpy) into clusters
    of ``cluster`` triangles, with the reference's calls in the
    reference's order."""
    cluster = check_cluster(cluster)
    order = bvh.build(np.asarray(v0), np.asarray(v1), np.asarray(v2)).tri_index
    a, bb, c = np.asarray(v0)[order], np.asarray(v1)[order], np.asarray(v2)[order]
    t = a.shape[0]
    tp = max(cluster, -(-t // cluster) * cluster)
    if tp >= 2 ** 31:
        raise ValueError(f"sweep cluster size {cluster}: {tp} padded triangles exceed the "
                         f"int32 triangle index (limit {2 ** 31 - 1})")

    def pad(x):
        return np.concatenate([x, np.full((tp - t,) + x.shape[1:], 0.0, x.dtype)])

    a, bb, c = pad(a), pad(bb), pad(c)
    tri_id = np.concatenate([order.astype(np.int32), np.full(tp - t, -1, np.int32)])
    e1 = bb - a
    e2 = c - a
    n = np.cross(e1, e2)
    k = np.sum(n * a, axis=1)
    g = np.zeros((24, tp), np.float32)
    for e, (p, q) in enumerate(((a, bb), (bb, c), (c, a))):
        g[8 * e:8 * e + 6] = np.concatenate([np.cross(p, q), q - p], axis=1).T
    gp = np.zeros((16, tp), np.float32)
    gp[0:3] = -n.T
    gp[3] = k
    gp[12:15] = n.T
    nc = tp // cluster
    tri_min = np.minimum(np.minimum(a, bb), c).reshape(nc, cluster, 3)
    tri_max = np.maximum(np.maximum(a, bb), c).reshape(nc, cluster, 3)
    gc = np.concatenate([g, gp], axis=0)
    return {
        "g_cluster": np.transpose(gc.reshape(ROWS, nc, cluster), (1, 0, 2)).copy(),
        "v0e1e2": np.concatenate([a, e1, e2], axis=1).astype(np.float32),
        "tri_id": tri_id,
        "cl_min": tri_min.min(axis=1),
        "cl_max": tri_max.max(axis=1),
        "num_tris": int(t),
    }


def sweep_scene_from_numpy(arrays: dict, device="cuda") -> SweepScene:
    """A SweepScene from numpy arrays: ``build_arrays``' output, or the
    fields of the JAX package's SweepScene of the same names; the cluster
    size is the last axis of ``g_cluster``, so a scene carried from the
    reference keeps its own."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    gc = t(arrays["g_cluster"]).to(torch.float32)
    return SweepScene(g_cluster=gc, v0e1e2=t(arrays["v0e1e2"]).to(torch.float32),
                      tri_id=t(arrays["tri_id"]).to(torch.int32),
                      cl_min=t(arrays["cl_min"]).to(torch.float32),
                      cl_max=t(arrays["cl_max"]).to(torch.float32),
                      num_tris=int(arrays["num_tris"]), n_clusters=int(gc.shape[0]),
                      cluster=check_cluster(int(gc.shape[2])))


def build(v0, v1, v2, *, cluster: int = CLUSTER, device="cuda") -> SweepScene:
    """Cluster and featurise a triangle soup on the host into clusters of
    ``cluster`` triangles (ValueError for a size the kernels cannot take:
    below 1, or padding the soup past the int32 triangle index), then
    move it to ``device``."""
    return sweep_scene_from_numpy(build_arrays(v0, v1, v2, cluster=cluster), device)


# ------------------------------------------- B4 slab entry and visit tables

def _order_sel(a, b):
    """(lo, hi) of a and b by one comparison, as csrc/slab_entry.cu does
    (no fminf/fmaxf, whose choice between -0 and +0 is unspecified)."""
    lt = a < b
    return torch.where(lt, a, b), torch.where(lt, b, a)


def slab_entry_plain(feats, tmax, cl_min, cl_max):
    """Plain PyTorch B4: (Rp // SUB, C) least slab entry per sub-block and
    cluster. Per ray and axis, inv = 1/d where |d| > 1e-12 else 1e12, and
    a, b = inv * box - o * inv; the ray enters the box at tn = max over
    axes of min(a, b), leaves at tf = min of max(a, b), pierces it iff
    tn <= min(tf, tmax) and tf > 0, and enters at max(tn, 0)."""
    tn = tf = None
    for k in range(3):
        d = feats[:, k:k + 1]
        inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)
        oinv = feats[:, 8 + k:9 + k] * inv
        lo, hi = _order_sel(inv * cl_min[None, :, k] - oinv, inv * cl_max[None, :, k] - oinv)
        tn = lo if tn is None else torch.where(lo > tn, lo, tn)
        tf = hi if tf is None else torch.where(hi < tf, hi, tf)
    tm = tmax[:, None]
    hit = (tn <= torch.where(tm < tf, tm, tf)) & (tf > 0.0)
    entry = torch.where(hit, torch.where(tn > 0.0, tn, 0.0), torch.inf)
    return entry.view(-1, check_ray_block()[1], entry.shape[1]).amin(1)


def tables_from_entries(e_sub):
    """The sweeps' visit tables from sub-block entries e_sub (Rp // SUB, C),
    as the reference builds them after its slab kernel. With e_blk the
    least entry of each ray block: order (B, C), its stable ascending
    argsort; e_bits (Rp // SUB, C), each sub-block's entries in visit
    order; blk_bits (B, C), e_blk in visit order; nlive (B,), the finite
    block entries. Entries are int32 float bits."""
    nsb, nc = e_sub.shape
    rb, sub = check_ray_block()
    nsub = rb // sub
    nb = nsb // nsub
    e = e_sub.view(nb, nsub, nc)
    e_blk = e.amin(1)
    order = torch.argsort(e_blk, dim=1, stable=True)
    e_bits = torch.gather(e, 2, order[:, None, :].expand(nb, nsub, nc))
    blk_sorted = torch.gather(e_blk, 1, order)
    return {
        "e_bits": e_bits.reshape(nsb, nc).view(torch.int32).contiguous(),
        "order": order.to(torch.int32).contiguous(),
        "blk_bits": blk_sorted.view(torch.int32).contiguous(),
        "nlive": torch.isfinite(blk_sorted).sum(1).to(torch.int32),
    }


def visit_tables_plain(o, d, tmax, cl_min, cl_max):
    """Plain PyTorch B4 with its tables: the rays' (Rp, 16) feature rows
    [d, m, 0, 0 | o, 1, d, 0] (m = o x d in plain float32),
    ``slab_entry_plain``, then ``tables_from_entries``."""
    m = m3.cross32(o, d)
    z = torch.zeros(o.shape[0], 1, dtype=torch.float32, device=o.device)
    feats = torch.cat([d, m, z, z, o, z + 1.0, d, z], 1).contiguous()
    return {"feats": feats,
            **tables_from_entries(slab_entry_plain(feats, tmax, cl_min, cl_max))}


def visit_tables_cuda(o, d, tmax, cl_min, cl_max):
    """B4 on the card: csrc/slab_entry.cu, the feature rows, the entries
    and the visit tables in one launch (one block per ray block), no host
    synchronisation; any ray block and sub-block pair ``check_ray_block``
    takes and any cluster count (above ``slab_smem_clusters()`` the blocks
    keep their tables in a global scratch allocated here)."""
    dev = o.device
    rp, nc = o.shape[0], cl_min.shape[0]
    rb, sub = check_ray_block()
    if rp % rb:
        raise ValueError(f"rays must fill whole blocks of {rb}")
    cuda_lib.require(o, "origin", torch.float32, (rp, 3))
    cuda_lib.require(d, "direction", torch.float32, (rp, 3), dev)
    cuda_lib.require(tmax, "tmax", torch.float32, (rp,), dev)
    cuda_lib.require(cl_min, "cl_min", torch.float32, (nc, 3), dev)
    cuda_lib.require(cl_max, "cl_max", torch.float32, (nc, 3), dev)
    nb, nsub = rp // rb, rb // sub
    out = {"feats": torch.empty(rp, FEATS, dtype=torch.float32, device=dev),
           "e_bits": torch.empty(rp // sub, nc, dtype=torch.int32, device=dev),
           "order": torch.empty(nb, nc, dtype=torch.int32, device=dev),
           "blk_bits": torch.empty(nb, nc, dtype=torch.int32, device=dev),
           "nlive": torch.empty(nb, dtype=torch.int32, device=dev)}
    scratch = (torch.empty(nb, nsub + 1, nc, dtype=torch.int32, device=dev)
               if nc > slab_smem_clusters() else None)
    err = cuda_lib.launch(o, cuda_lib.load().sailor_slab_tables,
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), cl_min.data_ptr(), cl_max.data_ptr(),
        *(t.data_ptr() for t in out.values()), 0 if scratch is None else scratch.data_ptr(),
        nb, nc, sub, nsub, cuda_lib.stream_of(o))
    cuda_lib.check(err, "sailor_slab_tables")
    cuda_lib.count("slab_entry")
    return out


def visit_tables(o, d, tmax, cl_min, cl_max):
    fn = cuda_lib.dispatch(o, visit_tables_plain, visit_tables_cuda)
    return fn(o, d, tmax, cl_min, cl_max)


# -------------------------------------------------------------- B5 cluster sweep

def _bits_max(t):
    """Per sub-block, the largest float32 bit pattern of t as an int32."""
    return t.view(torch.int32).view(-1, check_ray_block()[1]).amax(1)


def _walk_plain(e_bits, order, blk_bits, feats, tmax, g_cluster, *, any_hit: bool,
                work: dict | None):
    """The sweeps' shared plain walk, vectorised over sub-blocks: visit step
    by visit step, every sub-block whose entry bits are below its bound
    tests all (ray, triangle) pairs of the step's cluster, about
    ``_PLAIN_PAIRS`` pairs at a time. With ``blk_bits`` (B5) the walk stops at the first
    step where no sub-block is live and every block's sorted entry has
    reached its sub-blocks' bounds; without (B6) it visits every step. The
    six-term dots are summed left to right as the kernels sum them. The
    cluster size is ``g_cluster``'s last axis."""
    nb, nc = order.shape
    cluster = g_cluster.shape[2]
    sub = check_ray_block()[1]
    chunk = max(1, _PLAIN_PAIRS // (sub * cluster))
    nsb = feats.shape[0] // sub
    nsub = nsb // nb
    t = tmax.clone()
    idx = torch.full_like(t, -1, dtype=torch.int32)
    tv, iv = t.view(nsb, sub), idx.view(nsb, sub)
    bound = _bits_max(t)
    blk_of = torch.arange(nsb, device=feats.device) // nsub
    f = feats.view(nsb, sub, FEATS)
    col = torch.arange(cluster, device=feats.device, dtype=torch.int32)
    pairs = tests = 0
    for j in range(nc):
        live = (e_bits[:, j] < bound).nonzero()[:, 0]
        if live.numel() == 0:
            if blk_bits is not None and bool((blk_bits[blk_of, j] >= bound).all()):
                break  # entries are visit-sorted: no later step is live
            continue
        pairs += live.numel()
        for c0 in range(0, live.numel(), chunk):
            s = live[c0:c0 + chunk]
            cid = order[blk_of[s], j]
            g = g_cluster[cid.long()]                      # (n, 40, cluster)
            r = f[s]                                       # (n, sub, 16)

            def ray(k):
                return r[:, :, k:k + 1]

            def gr(k):
                return g[:, k:k + 1, :]

            side = []
            for e in range(3):
                acc = ray(0) * gr(8 * e)
                for k in range(1, 6):
                    acc = acc + ray(k) * gr(8 * e + k)
                side.append(acc)
            s0, s1, s2 = side
            num = ((ray(8) * gr(24) + ray(9) * gr(25)) + ray(10) * gr(26)) + gr(27)
            den = (ray(0) * gr(36) + ray(1) * gr(37)) + ray(2) * gr(38)
            agree = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                     | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
            tval = num / torch.where(den == 0.0, 1.0, den)
            best = tv[s][:, :, None]
            ok = agree & (den != 0.0) & (tval > 1e-4) & (tval < best)
            if work is not None:
                n_test = torch.full(best.shape[:2], cluster, device=feats.device)
                if any_hit:
                    first = ok.to(torch.uint8).argmax(2) + 1
                    n_test = torch.where(ok.any(2), first, n_test)
                tests += int(n_test[best[:, :, 0] > 1e-4].sum())
            if any_hit:
                found = ok.any(2)
                tv[s] = torch.where(found, -1.0, tv[s])
                iv[s] = torch.where(found, 0, iv[s])
            else:
                tm = torch.where(ok, tval, torch.inf)
                row_best = tm.amin(2)
                gidx = cid[:, None, None] * cluster + col
                row_idx = torch.where((tm == row_best[:, :, None]) & ok, gidx, -1).amax(2)
                found = row_idx >= 0
                tv[s] = torch.where(found, row_best, tv[s])
                iv[s] = torch.where(found, row_idx, iv[s])
            bound[s] = _bits_max(tv[s])
    if work is not None:
        work["pairs"] = work.get("pairs", 0) + pairs
        work["tests"] = work.get("tests", 0) + tests
    return t, idx


def sweep_plain(e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, *,
                any_hit: bool, work: dict | None = None):
    """Plain PyTorch B5 (``_walk_plain`` with the block-wide stop; ``nlive``
    is implied by ``blk_bits``, whose dead steps hold +inf bits). ``work``
    (a dict, if given) adds the work the kernel does on this data:
    ``pairs``, the (sub-block, step) pairs walked, and ``tests``, the (ray,
    triangle) tests of rays live at their step (best t > 1e-4; any hit
    stops a ray's step at its first hit). Returns (best_t (Rp,), best_i
    (Rp,) int32)."""
    return _walk_plain(e_bits, order, blk_bits, feats, tmax, g_cluster,
                       any_hit=any_hit, work=work)


def _g_cluster_size(g_cluster) -> int:
    """The cluster size of a (C, 40, cluster) ``g_cluster``, checked."""
    if g_cluster.dim() != 3:
        raise ValueError(f"g_cluster must be (C, {ROWS}, cluster), not {tuple(g_cluster.shape)}")
    return check_cluster(g_cluster.shape[2])


def sweep_cuda(e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, *,
               any_hit: bool):
    """B5 on the card: csrc/sweep.cu, one launch (one block per sub-block),
    the cluster size from ``g_cluster``, the ray block and sub-block sizes
    from the module."""
    dev = feats.device
    nb, nc = order.shape
    rp = feats.shape[0]
    rb, sub = check_ray_block()
    if rp != nb * rb or feats.shape[1] != FEATS:
        raise ValueError(f"feats must be ({nb * rb}, {FEATS})")
    nsb = rp // sub
    cuda_lib.require(feats, "feats", torch.float32)
    cuda_lib.require(e_bits, "e_bits", torch.int32, (nsb, nc), dev)
    cuda_lib.require(order, "order", torch.int32, (nb, nc), dev)
    cuda_lib.require(blk_bits, "blk_bits", torch.int32, (nb, nc), dev)
    cuda_lib.require(nlive, "nlive", torch.int32, (nb,), dev)
    cuda_lib.require(tmax, "tmax", torch.float32, (rp,), dev)
    cluster = _g_cluster_size(g_cluster)
    cuda_lib.require(g_cluster, "g_cluster", torch.float32, (nc, ROWS, cluster), dev)
    best_t = torch.empty(rp, dtype=torch.float32, device=dev)
    best_i = torch.empty(rp, dtype=torch.int32, device=dev)
    err = cuda_lib.launch(feats, cuda_lib.load().sailor_sweep,
        e_bits.data_ptr(), order.data_ptr(), blk_bits.data_ptr(), nlive.data_ptr(),
        feats.data_ptr(), tmax.data_ptr(), g_cluster.data_ptr(), best_t.data_ptr(),
        best_i.data_ptr(), nsb, rb // sub, sub, nc, cluster, int(any_hit),
        cuda_lib.stream_of(feats))
    cuda_lib.check(err, "sailor_sweep")
    cuda_lib.count("sweep")
    return best_t, best_i


def sweep(e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, *, any_hit: bool):
    fn = cuda_lib.dispatch(feats, sweep_plain, sweep_cuda)
    return fn(e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, any_hit=any_hit)


# ------------------------------------------------------ B6 dense-grid sweep

def sweep_grid_plain(e_bits, order, feats, tmax, g_cluster, *, any_hit: bool,
                     work: dict | None = None):
    """Plain PyTorch B6: every sub-block visits all the steps of its
    block's visit order and tests those whose entry bits are below its
    bound (``_walk_plain`` without the stop); ``work`` as ``sweep_plain``'s.
    Equals B5 bit for bit."""
    return _walk_plain(e_bits, order, None, feats, tmax, g_cluster,
                       any_hit=any_hit, work=work)


def sweep_grid_cuda(e_bits, order, feats, tmax, g_cluster, *, any_hit: bool):
    """B6 on the card: csrc/sweep_grid.cu, one launch (one block per
    sub-block), the cluster size from ``g_cluster``, the ray block and
    sub-block sizes from the module."""
    dev = feats.device
    nb, nc = order.shape
    rp = feats.shape[0]
    rb, sub = check_ray_block()
    if rp != nb * rb or feats.shape[1] != FEATS:
        raise ValueError(f"feats must be ({nb * rb}, {FEATS})")
    nsb = rp // sub
    cuda_lib.require(feats, "feats", torch.float32)
    cuda_lib.require(e_bits, "e_bits", torch.int32, (nsb, nc), dev)
    cuda_lib.require(order, "order", torch.int32, (nb, nc), dev)
    cuda_lib.require(tmax, "tmax", torch.float32, (rp,), dev)
    cluster = _g_cluster_size(g_cluster)
    cuda_lib.require(g_cluster, "g_cluster", torch.float32, (nc, ROWS, cluster), dev)
    best_t = torch.empty(rp, dtype=torch.float32, device=dev)
    best_i = torch.empty(rp, dtype=torch.int32, device=dev)
    err = cuda_lib.launch(feats, cuda_lib.load().sailor_sweep_grid,
        e_bits.data_ptr(), order.data_ptr(), feats.data_ptr(), tmax.data_ptr(),
        g_cluster.data_ptr(), best_t.data_ptr(), best_i.data_ptr(), nsb,
        rb // sub, sub, nc, cluster, int(any_hit), cuda_lib.stream_of(feats))
    cuda_lib.check(err, "sailor_sweep_grid")
    cuda_lib.count("sweep_grid")
    return best_t, best_i


def sweep_grid(e_bits, order, feats, tmax, g_cluster, *, any_hit: bool):
    fn = cuda_lib.dispatch(feats, sweep_grid_plain, sweep_grid_cuda)
    return fn(e_bits, order, feats, tmax, g_cluster, any_hit=any_hit)


# ---------------------------------------------------------------- intersect

def _pad_rays(origin, direction, t_max, active):
    """Rays padded to whole ray blocks with dead rays (d = 1e-8, tmax = -1):
    (o, d, tmax), each Rp long."""
    r = origin.shape[0]
    dev = origin.device
    rb = check_ray_block()[0]
    rpad = -(-max(r, rb) // rb) * rb
    o = torch.zeros(rpad, 3, dtype=torch.float32, device=dev)
    d = torch.full((rpad, 3), 1e-8, dtype=torch.float32, device=dev)
    o[:r], d[:r] = origin, direction
    tmax = torch.full((rpad,), -1.0, dtype=torch.float32, device=dev)
    if t_max is None:
        tmax[:r] = torch.inf
    else:
        tmax[:r] = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    if active is not None:
        tmax[:r] = torch.where(active, tmax[:r], -1.0)
    return o, d, tmax


def _tables(scene: SweepScene, o, d, tmax):
    """The kernels' inputs for padded rays (see ``prepare``)."""
    return {"tmax": tmax, **visit_tables(o.contiguous(), d.contiguous(), tmax,
                                         scene.cl_min, scene.cl_max)}


def prepare(scene: SweepScene, origin, direction, t_max=None, active=None):
    """The kernels' inputs for R rays, padded to whole ray blocks with dead
    rays (d = 1e-8, tmax = -1): dict of tmax (Rp,) and B4's outputs: feats
    (Rp, 16) and the visit tables e_bits (Rp/SUB, C) int32 (the sub-block
    entries, as float32 bits, in visit order), order (B, C) int32 (visit
    order: stable argsort of the block entries), blk_bits (B, C) int32
    (sorted block entries) and nlive (B,) int32 (finite block entries)."""
    return _tables(scene, *_pad_rays(origin, direction, t_max, active))


def ray_order(scene: SweepScene, o, d, tmax):
    """``sort_rays``' permutation of padded rays and its inverse: a stable
    sort by the first cluster each ray's segment enters (the least slab
    entry, the first such cluster on ties, ``n_clusters`` when it enters
    none) times 64 plus a direction code (each component of d + 1 doubled,
    truncated and clamped to 0..3). The slab pass is the reference's XLA
    form, with t_n unclamped."""
    nc = scene.n_clusters
    tn = tf = None
    for k in range(3):
        inv = torch.where(d[:, k:k + 1].abs() > 1e-12, 1.0 / d[:, k:k + 1], 1e12)
        oinv = o[:, k:k + 1] * inv
        a = inv * scene.cl_min[None, :, k] - oinv
        b = inv * scene.cl_max[None, :, k] - oinv
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    hit = (tn <= torch.minimum(tf, tmax[:, None])) & (tf > 0.0)
    entry = torch.where(hit, tn, torch.inf)
    fc = torch.where(hit.any(1), entry.argmin(1), nc).to(torch.int32)
    qd = ((d + 1.0) * 2.0).to(torch.int32).clamp(0, 3)
    dq = (qd[:, 0] * 4 + qd[:, 1]) * 4 + qd[:, 2]
    perm = torch.sort(fc * 64 + dq, stable=True).indices
    return perm, torch.sort(perm, stable=True).indices


def intersect(scene: SweepScene, origin, direction, t_max=None, *,
              any_hit: bool = False, active=None, sort_rays: bool = False):
    """Closest (or any) hit of R rays: dict(t, tri (original id), u, v,
    hit), as the reference's ``intersect``. ``sort_rays`` sorts the rays by
    ``ray_order`` before the kernels and restores the winners' order after;
    ``DMA_SWEEP`` picks B5 or B6."""
    r = origin.shape[0]
    o, d, tmax = _pad_rays(origin, direction, t_max, active)
    if sort_rays:
        perm, inv = ray_order(scene, o, d, tmax)
        o, d, tmax = o[perm], d[perm], tmax[perm]
    p = _tables(scene, o, d, tmax)
    if DMA_SWEEP:
        best_t, best_i = sweep(p["e_bits"], p["order"], p["blk_bits"], p["nlive"],
                               p["feats"], p["tmax"], scene.g_cluster, any_hit=any_hit)
    else:
        best_t, best_i = sweep_grid(p["e_bits"], p["order"], p["feats"], p["tmax"],
                                    scene.g_cluster, any_hit=any_hit)
    if sort_rays:
        best_t, best_i = best_t[inv], best_i[inv]
    best_t, best_i = best_t[:r], best_i[:r]
    if any_hit:
        hit = best_i >= 0
        zero = torch.zeros(r, dtype=torch.float32, device=origin.device)
        return {"t": torch.where(hit, 0.0, torch.inf), "tri": torch.where(hit, 0, -1),
                "u": zero, "v": zero, "hit": hit}
    return _refine(scene, origin, direction, best_t, best_i)


def _refine(scene, origin, direction, best_t, best_i):
    """Exact Moller-Trumbore on the winner rows: float32 t/u/v and the
    original triangle id."""
    hit = best_i >= 0
    safe = best_i.clamp(min=0).long()
    rows = scene.v0e1e2[safe]
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pvec = m3.cross32(direction, e2)
    det = m3.dot32(e1, pvec)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvec = origin - v0
    u = m3.dot32(tvec, pvec) * inv_det
    qvec = m3.cross32(tvec, e1)
    v = m3.dot32(direction, qvec) * inv_det
    t = m3.dot32(e2, qvec) * inv_det
    return {
        "t": torch.where(hit, t, torch.inf),
        "tri": torch.where(hit, scene.tri_id[safe], -1),
        "u": torch.where(hit, u, 0.0).clamp(0.0, 1.0),
        "v": torch.where(hit, v, 0.0).clamp(0.0, 1.0),
        "hit": hit,
    }
