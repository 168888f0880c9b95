"""8-wide BVH in one packed row table, and its traversal (counterpart of
sailor_tpu/raytracing/bvh8.py).

Every node is one row of an (N, ROW) float32 table:

- internal row: the 8 children's AABBs in SoA slots (min x/y/z, max x/y/z,
  8 each), the child row indices (int32 bits; children are contiguous
  rows, -1 marks an empty slot, whose AABB is inverted so it never hits);
- leaf row: up to 7 triangles in Moller-Trumbore form (v0, e1, e2 in SoA
  slots) and their original ids (int32 bits, -1 empty);
- column 71 holds 1.0 for a leaf, 0.0 for an internal row.

``build`` makes the table on the host: with ``use_native`` (the default)
by the port's copy of the JAX package's native builder
(``csrc/bvh8_build.cpp``: binned SAH with 7-triangle leaves, then the
collapse), otherwise by a numpy copy of the reference's ``_collapse`` over
``bvh.build`` (4-triangle leaves). The two give different tables.

``intersect`` traverses it. The reference runs all rays in one lockstep
``lax.while_loop`` in which each ray's state evolves on its own (a dead
ray parks on row 0 and changes nothing), so any schedule that runs each
ray's steps in order gives the same result per ray: the kernel
``csrc/bvh8.cu`` (no TPU counterpart; one launch per pass; persistent warps
whose lanes take a new ray as theirs finish) and its plain twin
``intersect_plain`` evaluate the same float32 operations in the same order.
Per iteration a ray reads its row:

- a leaf tests its triangles (|det| > 1e-10, u >= 0, v >= 0, u + v <= 1,
  1e-4 < t < best t) and takes the least t; among the triangles at that t
  it takes the largest id, the largest u and the largest v, each on its
  own (on an exact tie u and v may come from two triangles);
- an internal row slab-tests its 8 children (the entry clamped at 0 on the
  z pair only, as the reference writes it), splits the hit ones at the
  midpoint of their entries into a near and a far group, and pushes
  (first child << 8 | mask) entries, far first. A push that would reach
  ``MAX_STACK`` is dropped and its subtree lost, as in the reference;
- then it pops the lowest set bit of the top entry's mask.

An any-hit ray stops once it has a hit (checked after the iteration's
pushes and pop). Inactive rays return t_max (inf), tri -1, u = v = 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sailor_tpu_torch import native_bridge
from sailor_tpu_torch.core.math3d import fma
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.raytracing import bvh as bvh2

ROW = 72          # row width in float32 columns
MAX_CHILDREN = 8
MAX_LEAF = 7
MAX_STACK = 12    # stack entries a ray holds

# internal row
_I_MIN = 0        # [0:24]  minx[8], miny[8], minz[8]
_I_MAX = 24       # [24:48] maxx[8], maxy[8], maxz[8]
_I_CHILD = 48     # [48:56] child row index (int32 bits), -1 = empty
_FLAG = 71        # 0.0 = internal, 1.0 = leaf
# leaf row
_L_V0 = 0         # [0:21]  v0x[7], v0y[7], v0z[7]
_L_E1 = 21        # [21:42] e1x[7], e1y[7], e1z[7]
_L_E2 = 42        # [42:63] e2x[7], e2y[7], e2z[7]
_L_ID = 63        # [63:70] original triangle id (int32 bits), -1 = empty

# bytes of a row a ray reads: the half its flag selects, and the flag
LEAF_ROW_BYTES = 4 * (3 * 3 * MAX_LEAF + MAX_LEAF + 1)
INNER_ROW_BYTES = 4 * (6 * MAX_CHILDREN + MAX_CHILDREN + 1)
MAX_ROWS = 1 << 23  # entries hold (row << 8) in an int32


@dataclasses.dataclass
class BVH8:
    table: torch.Tensor  # (N, ROW) float32
    num_tris: int


def _collapse(b: bvh2.BVH) -> np.ndarray:
    """Collapse a binary BVH into packed 8-wide rows: the reference's
    ``_collapse``, call for call."""
    n_min, n_max = b.node_min, b.node_max
    n_left, n_start, n_count = b.node_left, b.node_start, b.node_count
    tv0, tv1, tv2, tid = b.v0, b.v1, b.v2, b.tri_index
    rows: list[np.ndarray] = []

    def new_row():
        rows.append(np.zeros(ROW, np.float32))
        return len(rows) - 1

    def pack_leaf(row_id, start, count):
        row = rows[row_id]
        ids = np.full(MAX_LEAF, -1, np.int32)
        for k in range(count):
            t = start + k
            a, e1, e2 = tv0[t], tv1[t] - tv0[t], tv2[t] - tv0[t]
            for c in range(3):
                row[_L_V0 + 7 * c + k] = a[c]
                row[_L_E1 + 7 * c + k] = e1[c]
                row[_L_E2 + 7 * c + k] = e2[c]
            ids[k] = tid[t]
        row[_L_ID:_L_ID + MAX_LEAF] = ids.view(np.float32)
        row[_FLAG] = 1.0

    def area(i):
        d = np.maximum(n_max[i] - n_min[i], 0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    def gather_children(node):
        """Split binary children until up to 8 slots (largest area first)."""
        slots = [node]
        while len(slots) < MAX_CHILDREN:
            cand = [s for s in slots if n_count[s] == 0]
            if not cand:
                break
            s = max(cand, key=area)
            slots.remove(s)
            slots.extend([n_left[s], n_left[s] + 1])
        return slots

    def fill(row_id, node):
        if n_count[node] > 0:
            pack_leaf(row_id, n_start[node], n_count[node])
            return
        slots = gather_children(node)
        row = rows[row_id]
        child_ids = np.full(MAX_CHILDREN, -1, np.int32)
        child_rows = [new_row() for _ in slots]
        for k, s in enumerate(slots):
            fill(child_rows[k], s)
            child_ids[k] = child_rows[k]
            for c in range(3):
                row[_I_MIN + 8 * c + k] = n_min[s][c]
                row[_I_MAX + 8 * c + k] = n_max[s][c]
        for k in range(len(slots), MAX_CHILDREN):  # empty: inverted AABB
            for c in range(3):
                row[_I_MIN + 8 * c + k] = 1.0
                row[_I_MAX + 8 * c + k] = -1.0
        row[_I_CHILD:_I_CHILD + MAX_CHILDREN] = child_ids.view(np.float32)
        row[_FLAG] = 0.0

    fill(new_row(), 0)
    return np.stack(rows)


def build_table(v0, v1, v2, use_native: bool = True) -> np.ndarray:
    """The packed (N, ROW) float32 table of a triangle soup (host)."""
    if use_native:
        table = native_bridge.bvh8_build(v0, v1, v2)
    else:
        v0, v1, v2 = (np.asarray(x) for x in (v0, v1, v2))
        table = _collapse(bvh2.build(v0, v1, v2))
    if len(table) >= MAX_ROWS:
        raise ValueError(f"{len(table)} rows: stack entries hold row << 8 in an int32")
    return table


def build(v0, v1, v2, use_native: bool = True, device="cuda") -> BVH8:
    """Build the packed 8-wide BVH on the host and move it to ``device``.

    ``use_native`` builds with the port's host C++ library
    (``csrc/bvh8_build.cpp``, built at first use by ``kernels/host_lib.py``),
    else with the numpy collapse of ``bvh.build``. Unlike the reference,
    which silently returns to its Python builder when its toolchain is
    missing, this raises if the host library cannot be built: the two
    builders give different tables (7-triangle leaves against 4-triangle
    leaves collapsed), and so may break ties between equal hit distances
    differently."""
    table = build_table(v0, v1, v2, use_native)
    return BVH8(table=torch.from_numpy(table).to(device), num_tris=len(v0))


def from_numpy(table: np.ndarray, num_tris: int, device="cuda") -> BVH8:
    """A BVH8 from a packed table (this module's or the JAX package's)."""
    table = np.array(table, np.float32)
    if table.ndim != 2 or table.shape[1] != ROW or len(table) >= MAX_ROWS:
        raise ValueError(f"a BVH8 table is (N < 2^23, {ROW}) float32, got {table.shape}")
    return BVH8(table=torch.from_numpy(table).to(device), num_tris=int(num_tris))


# -------------------------------------------------------------- traversal

def _i32(x):
    return x.contiguous().view(torch.int32)


def _low_bit_index(low):
    """Index of the single set bit of ``low`` (1, 2, ..., 128), as the
    reference takes it from the float32 exponent."""
    return (low.to(torch.float32).view(torch.int32) >> 23) - 127


def _warps_with(idx, lanes):
    """The count of 32-ray warps (by ray index; ``idx`` ascending) that hold
    a ray where ``lanes`` is true."""
    return int(torch.unique_consecutive(idx[lanes] // 32).numel())


def intersect_plain(table, origin, direction, t0, active, *, any_hit: bool,
                    work: dict | None = None, on_step=None):
    """Plain PyTorch traversal: the reference's loop body on the rays still
    live, until none is (one host read an iteration). ``t0`` (R,) float32 is
    each ray's start bound; ``active`` (R,) bool. Returns (t, tri, u, v).
    ``work`` (a dict, if given) adds the rows read (``leaf_rows``,
    ``inner_rows``), the distinct rows read by this call
    (``distinct_leaf_rows``, ``distinct_inner_rows``), the ``iterations``,
    the ``dropped_pushes`` and what a one-thread-a-ray mapping would run,
    warps being 32 consecutive rays: ``lane_steps`` (rows stepped, leaf
    and internal), ``warp_steps`` (over warps, the rows of the longest
    walk) and ``warp_branch_steps`` (warp steps that run the leaf branch
    plus those that run the internal branch). ``on_step(idx, is_leaf)``,
    if given, sees each iteration's live rays (ascending) and whether each
    one's row is a leaf."""
    dev = origin.device
    r = origin.shape[0]
    t_out, u_out, v_out = t0.clone(), torch.zeros(r, device=dev), torch.zeros(r, device=dev)
    tri_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    idx = torch.nonzero(active).squeeze(1)
    o, d = origin[idx], direction[idx]
    inv = torch.where(d.abs() > 1e-12, 1.0 / d, 1e12)
    n = idx.numel()
    stack = torch.zeros(n, MAX_STACK, dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    t_best = t0[idx].clone()
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best, v_best = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    bits = (1 << torch.arange(MAX_CHILDREN, device=dev, dtype=torch.int32))
    counts = {"leaf_rows": 0, "inner_rows": 0, "iterations": 0, "dropped_pushes": 0,
              "lane_steps": 0, "warp_steps": 0, "warp_branch_steps": 0}
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    while idx.numel():
        seen[node] = True
        row = table[node]
        is_leaf = row[:, _FLAG] > 0.5
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        # ---- leaf: Moller-Trumbore against its 7 triangles
        v0x, v0y, v0z = (row[:, _L_V0 + 7 * c:_L_V0 + 7 * c + 7] for c in range(3))
        e1x, e1y, e1z = (row[:, _L_E1 + 7 * c:_L_E1 + 7 * c + 7] for c in range(3))
        e2x, e2y, e2z = (row[:, _L_E2 + 7 * c:_L_E2 + 7 * c + 7] for c in range(3))
        ids = _i32(row[:, _L_ID:_L_ID + MAX_LEAF])
        # the reference's compiled loop fuses these products (ROADMAP C 2):
        # a * b - c * d as fma(a, b, -(c * d)); det, u and v as
        # fma(z, z', fma(x, x', y * y')); t as fma(z, z', fma(y, y', x * x'))
        px = fma(dy, e2z, -(dz * e2y))
        py = fma(dz, e2x, -(dx * e2z))
        pz = fma(dx, e2y, -(dy * e2x))
        det = fma(e1z, pz, fma(e1x, px, e1y * py))
        inv_det = torch.where(det.abs() > 1e-10, 1.0 / det, 0.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = fma(sz, pz, fma(sx, px, sy * py)) * inv_det
        qx = fma(sy, e1z, -(sz * e1y))
        qy = fma(sz, e1x, -(sx * e1z))
        qz = fma(sx, e1y, -(sy * e1x))
        v = fma(dz, qz, fma(dx, qx, dy * qy)) * inv_det
        t = fma(e2z, qz, fma(e2y, qy, e2x * qx)) * inv_det
        ok = (is_leaf[:, None] & (ids >= 0) & (det.abs() > 1e-10) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > 1e-4) & (t < t_best[:, None]))
        t_cand = torch.where(ok, t, torch.inf)
        t_leaf = t_cand.amin(1)
        win = t_cand == t_leaf[:, None]
        take = torch.isfinite(t_leaf)
        t_best = torch.where(take, t_leaf, t_best)
        tri_best = torch.where(take, torch.where(win, ids, -1).amax(1), tri_best)
        u_best = torch.where(take, torch.where(win, u, -torch.inf).amax(1), u_best)
        v_best = torch.where(take, torch.where(win, v, -torch.inf).amax(1), v_best)
        # ---- internal: slab-test the 8 children
        mn = [row[:, _I_MIN + 8 * c:_I_MIN + 8 * c + 8] for c in range(3)]
        mx = [row[:, _I_MAX + 8 * c:_I_MAX + 8 * c + 8] for c in range(3)]
        child = _i32(row[:, _I_CHILD:_I_CHILD + MAX_CHILDREN])
        ts = [((mn[c] - o[:, c:c + 1]) * inv[:, c:c + 1],
               (mx[c] - o[:, c:c + 1]) * inv[:, c:c + 1]) for c in range(3)]
        (tx0, tx1), (ty0, ty1), (tz0, tz1) = ts
        tnear = torch.maximum(
            torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
            torch.clamp_min(torch.minimum(tz0, tz1), 0.0))
        tfar = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                             torch.maximum(tz0, tz1))
        chit = ((tfar >= tnear) & (tnear < t_best[:, None]) & (child >= 0)
                & ~is_leaf[:, None])
        tn_min = torch.where(chit, tnear, torch.inf).amin(1)
        tn_max = torch.where(chit, tnear, -torch.inf).amax(1)
        thresh = 0.5 * (tn_min + tn_max)
        near_g = chit & (tnear <= thresh[:, None])
        far_g = chit & ~near_g
        mask_near = torch.where(near_g, bits, 0).sum(1, dtype=torch.int32)
        mask_far = torch.where(far_g, bits, 0).sum(1, dtype=torch.int32)
        base0 = child[:, 0]
        # ---- pushes, far first; a push at MAX_STACK is dropped
        lanes = torch.arange(n, device=dev)
        for mask in (mask_far, mask_near):
            want = mask > 0
            push = want & (sp < MAX_STACK)
            counts["dropped_pushes"] += int((want & ~push).sum())
            pl = lanes[push]
            stack[pl, sp[push]] = (base0[push] << 8) | mask[push]
            sp = sp + push.to(torch.int64)
        # ---- pop the lowest set bit of the top entry
        has = sp > 0
        top_i = (sp - 1).clamp(min=0)
        top = stack[lanes, top_i]
        tmask, tbase = top & 0xFF, top >> 8
        k = _low_bit_index(tmask & -tmask)
        rem = tmask & (tmask - 1)
        new_top = torch.where(rem > 0, (tbase << 8) | rem, 0)
        stack[lanes[has], top_i[has]] = new_top[has]
        sp = torch.where(has & (rem == 0), top_i, sp)
        node = (tbase + k).to(torch.int64)
        nleaf = int(is_leaf.sum())
        counts["leaf_rows"] += nleaf
        counts["inner_rows"] += n - nleaf
        counts["iterations"] += 1
        if work is not None:
            counts["lane_steps"] += n
            counts["warp_steps"] += _warps_with(idx, slice(None))
            counts["warp_branch_steps"] += (_warps_with(idx, is_leaf)
                                            + _warps_with(idx, ~is_leaf))
        if on_step is not None:
            on_step(idx, is_leaf)
        keep = has & (tri_best < 0) if any_hit else has
        # retire the rays that stopped, keep the others
        gone = ~keep
        g = idx[gone]
        t_out[g], tri_out[g], u_out[g], v_out[g] = (t_best[gone], tri_best[gone],
                                                    u_best[gone], v_best[gone])
        idx, o, d, inv = idx[keep], o[keep], d[keep], inv[keep]
        stack, sp, node = stack[keep], sp[keep], node[keep]
        t_best, tri_best, u_best, v_best = (t_best[keep], tri_best[keep], u_best[keep],
                                            v_best[keep])
        n = idx.numel()
    if work is not None:
        leaf = table[:, _FLAG] > 0.5
        counts["distinct_leaf_rows"] = int((seen & leaf).sum())
        counts["distinct_inner_rows"] = int((seen & ~leaf).sum())
        for key, val in counts.items():
            work[key] = work.get(key, 0) + val
    return t_out, tri_out, u_out, v_out


def intersect_cuda(table, origin, direction, t0, active, *, any_hit: bool):
    """The traversal on the card: csrc/bvh8.cu, persistent warps that refill
    finished lanes, one launch. The table's rows are read as float4s, so it
    must start on a 16-byte boundary."""
    dev = origin.device
    r = origin.shape[0]
    nrows = table.shape[0]
    cuda_lib.require(table, "table", torch.float32, (nrows, ROW))
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel reads rows as float4s; expected a 16-byte "
                         "aligned start")
    cuda_lib.require(origin, "origin", torch.float32, (r, 3), table.device)
    cuda_lib.require(direction, "direction", torch.float32, (r, 3), dev)
    cuda_lib.require(t0, "t0", torch.float32, (r,), dev)
    cuda_lib.require(active, "active", torch.bool, (r,), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)  # cleared by the C entry
    err = cuda_lib.launch(origin, cuda_lib.load().sailor_bvh8_intersect,
        table.data_ptr(), origin.data_ptr(), direction.data_ptr(), t0.data_ptr(),
        active.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr(), r,
        int(any_hit), counter.data_ptr(), cuda_lib.stream_of(origin))
    cuda_lib.check(err, "sailor_bvh8_intersect")
    cuda_lib.count("bvh8_intersect")
    return t, tri, u, v


def kernel_info() -> dict:
    """The traversal kernel as built for the current card: registers a
    thread, static shared and local bytes, resident blocks on all SMs (a
    launch's grid when it has the rays to fill them), threads a block and
    the idle lanes at which a warp fetches more rays (``refill_idle``)."""
    import ctypes

    info = (ctypes.c_int * 6)()
    cuda_lib.check(cuda_lib.load().sailor_bvh8_info(ctypes.addressof(info)), "sailor_bvh8_info")
    return dict(zip(("registers", "shared_bytes", "local_bytes", "resident_blocks",
                     "threads", "refill_idle"), info))


def ray_inputs(origin, direction, t_max=None, active=None):
    """The kernel's per-ray inputs: contiguous float32 origin and direction,
    the start bound t0 (inf, or ``t_max`` broadcast) and ``active`` (all
    true by default)."""
    r = origin.shape[0]
    dev = origin.device
    if t_max is None:
        t0 = torch.full((r,), torch.inf, device=dev)
    else:
        t0 = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r).contiguous()
    act = (torch.ones(r, dtype=torch.bool, device=dev) if active is None
           else active.to(device=dev, dtype=torch.bool).contiguous())
    return (origin.to(torch.float32).contiguous(), direction.to(torch.float32).contiguous(),
            t0, act)


def intersect(bvh8: BVH8, origin, direction, t_max=None, *, any_hit: bool = False,
              active=None):
    """Closest (or any) hit of R rays: dict(t, tri (original triangle id,
    -1 = miss), u, v, hit). ``active`` (R,) bool: rays that start dead."""
    args = ray_inputs(origin, direction, t_max, active)
    fn = cuda_lib.dispatch(args[0], intersect_plain, intersect_cuda)
    t, tri, u, v = fn(bvh8.table, *args, any_hit=any_hit)
    return {"t": t, "tri": tri, "u": u, "v": v, "hit": tri >= 0}
