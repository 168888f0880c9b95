"""Multi-device rendering over screen-row shards (counterpart of
sailor_tpu/parallel/mesh.py).

The frame is split by pixel rows, in whole 32-row tile rows: every shard
rasters, culls, shades and post-processes its own slice, and the passes
that read across slices exchange data through the shard's communicator
(``Comm``): the exposure histogram is a ``psum``, bloom, the half-resolution
AO and the motion blur's tap table are ``all_gather``-ed, and the
boundary-exact upsamples, blurs and AO read halo rows by ``ppermute``. The
geometry, lights, camera and the replicated temporal state are shared.

Runtime. A ``Mesh`` is a list of devices; ``make_mesh(n, device="cuda")``
puts shard i on ``cuda:{i % torch.cuda.device_count()}`` (the shards of
one card share it), ``device="cpu"`` puts every shard on the CPU.
``Mesh.run(body)`` calls ``body(comm)`` once a shard, each in its own
Python thread (eager PyTorch releases the GIL while an operator runs),
each on its own CUDA stream and with its device made current for the
thread. The shards of one device take turns on the host (``_Turn``):
one runs Python at a time and hands the turn on at each collective, while
the device still overlaps their streams. Threads that all issue eager
operators at once fight over the interpreter lock at every one and
oversubscribe the CPU's cores: 4 shards of a 512 x 512 trace on one H100
took 1369-1408 ms at once and 235-246 ms taking turns; two 128 x 256
frames over 8 CPU shards took 10.2-14.3 s at once and 5.7-8.4 s taking
turns on an 8-core host (``tests/torch_shard_turns.py`` times both ways).
Shards on different cards run at once. ``torch.distributed`` is
not used: NCCL refuses two ranks on one GPU, so a process group could
not run the shards of one card.

The collectives are:

- deterministic: ``psum`` adds in shard order 0..n-1, ``all_gather``
  concatenates in shard order;
- safe across streams: a tensor handed to another shard carries an event
  recorded on the writer's stream, the reader's stream waits on it before
  it reads, and the tensor is recorded on the reader's stream so that the
  caching allocator does not reuse its memory early;
- never hanging: every barrier wait has a timeout (``Mesh.timeout``); an
  exception in one shard aborts the barrier, every other shard stops at
  its next collective, and ``run`` raises the first error.

Entry points besides ``FrameGraph.process_sharded``:
``sharded_forward_frame`` (a Forward+ frame through B9, the dense-bin
raster) and ``sharded_path_trace`` (the path tracer's rows split over the
shards).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import torch

from sailor_tpu_torch import config as cfg
from sailor_tpu_torch.config import resolve_device
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import bloom as bloom_k
from sailor_tpu_torch.kernels import histogram as hist_k
from sailor_tpu_torch.kernels import light_culling, pbr
from sailor_tpu_torch.kernels import tonemap as tm
from sailor_tpu_torch.kernels.common import round_up
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster

#: seconds a shard waits at a collective before the run is abandoned
DEFAULT_TIMEOUT = 600.0


class CollectiveError(RuntimeError):
    """A collective could not complete: another shard failed or timed out."""


class _Turn:
    """The host turn of the shards that share one device: one of them runs
    Python at a time and hands the turn on while it waits at a
    collective. Threads that all run eager PyTorch fight over the
    interpreter lock at every operator; taking turns removes the fight,
    and the device still overlaps the shards' streams."""

    def __init__(self, timeout: float):
        self.lock = threading.Lock()
        self.timeout = timeout
        self.owner = None

    def take(self) -> None:
        if not self.lock.acquire(timeout=self.timeout):
            raise CollectiveError("no host turn within the timeout: a shard holds it")
        self.owner = threading.get_ident()

    def give(self) -> None:
        """Hand the turn on if the calling thread holds it."""
        if self.owner == threading.get_ident():
            self.owner = None
            self.lock.release()


class _Exchange:
    """One slot a shard and a two-phase barrier: post, wait, read, wait (the
    second wait keeps a slot from being overwritten before every shard has
    read it). A shard gives up its host turn (``_Turn``) while it waits."""

    def __init__(self, n: int, timeout: float):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def wait(self) -> None:
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise CollectiveError("collective abandoned: another shard failed "
                                  "or the barrier timed out") from None

    def swap(self, index: int, value, turn=None) -> list:
        self.slots[index] = value
        if turn is not None:
            turn.give()
        try:
            self.wait()
            values = list(self.slots)
            self.wait()
        finally:
            if turn is not None:
                turn.take()
        return values


class Comm:
    """One shard's view of the mesh: its index, the shard count and the
    collectives over the screen axis."""

    def __init__(self, mesh: "Mesh", index: int, exchange: _Exchange, turn=None):
        self.mesh = mesh
        self.index = index
        self.size = mesh.size
        self.device = mesh.devices[index]
        self._ex = exchange
        self._turn = turn

    def _swap(self, tensors: tuple) -> list:
        """Post ``tensors`` (a tuple), return every shard's tuple in shard
        order, unread (``_take`` moves one onto this shard)."""
        event = None
        if self.device.type == "cuda" and tensors:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return self._ex.swap(self.index, (tensors, event), self._turn)

    def _take(self, posted, k: int):
        tensors, event = posted
        x = tensors[k]
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if event is not None:
                stream.wait_event(event)
            if x.device != self.device:
                return x.to(self.device)
            if x.is_cuda:
                x.record_stream(stream)
            return x
        return x.to(self.device)

    def all_gather(self, x, axis: int = 0):
        """Every shard's ``x`` concatenated along ``axis`` in shard order
        (``jax.lax.all_gather(..., tiled=True)``)."""
        posted = self._swap((x,))
        return torch.cat([self._take(p, 0) for p in posted], dim=axis)

    def gather(self, x, root: int = 0, axis: int = 0):
        """``all_gather`` whose result only ``root`` builds; the others get
        None."""
        posted = self._swap((x,))
        if self.index != root:
            return None
        return torch.cat([self._take(p, 0) for p in posted], dim=axis)

    def psum(self, x):
        """The sum of every shard's ``x``, added in shard order 0..n-1."""
        posted = self._swap((x,))
        acc = self._take(posted[0], 0)
        for p in posted[1:]:
            acc = acc + self._take(p, 0)
        return acc

    def ppermute(self, x, perm):
        """``x`` of the shard ``s`` with (s, self) in ``perm``; zeros where
        no shard sends (``jax.lax.ppermute``)."""
        posted = self._swap((x,))
        for s, d in perm:
            if d == self.index:
                return self._take(posted[s], 0)
        return torch.zeros_like(x)

    def neighbour_rows(self, top, bottom):
        """One exchange with both neighbours: (the previous shard's
        ``bottom``, the next shard's ``top``), None past the first and the
        last shard."""
        posted = self._swap((top, bottom))
        prev = self._take(posted[self.index - 1], 1) if self.index > 0 else None
        nxt = self._take(posted[self.index + 1], 0) if self.index < self.size - 1 else None
        return prev, nxt


@dataclasses.dataclass
class Mesh:
    """Shards over a list of devices along one named axis."""

    devices: tuple
    axis: str = "screen"
    timeout: float = DEFAULT_TIMEOUT
    _streams: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return len(self.devices)

    def placement(self) -> list[str]:
        """Where each shard runs, in shard order."""
        return [str(d) for d in self.devices]

    def _stream(self, i: int):
        if i not in self._streams:
            self._streams[i] = torch.cuda.Stream(device=self.devices[i])
        return self._streams[i]

    def run(self, body):
        """``[body(comm_0), ..., body(comm_{n-1})]``, each shard in its own
        thread. The shards' streams first wait on the caller's current
        streams, and the caller's streams wait on the shards' before
        ``run`` returns, so the results are ready on the caller's streams.
        The first exception of a shard (the lowest index among those that
        did not merely see the barrier break) is raised."""
        n = self.size
        ex = _Exchange(n, self.timeout)
        results: list = [None] * n
        errors: list = [None] * n
        callers = {d: torch.cuda.current_stream(d) for d in set(self.devices)
                   if d.type == "cuda"}
        turns = {d: _Turn(self.timeout) for d in set(self.devices)
                 if self.devices.count(d) > 1}
        done = {}

        def work(i):
            dev = self.devices[i]
            turn = turns.get(dev)
            try:
                if turn is not None:
                    turn.take()
                comm = Comm(self, i, ex, turn)
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                    stream = self._stream(i)
                    stream.wait_stream(callers[dev])
                    with torch.cuda.stream(stream):
                        results[i] = body(comm)
                        ev = torch.cuda.Event()
                        ev.record(stream)
                        done[i] = ev
                else:
                    results[i] = body(comm)
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                errors[i] = e
                ex.barrier.abort()
            finally:
                if turn is not None:
                    turn.give()

        finished: queue.Queue = queue.Queue()

        def thread(i):
            try:
                work(i)
            finally:
                finished.put(i)

        for i in range(n):
            threading.Thread(target=thread, args=(i,), name=f"shard-{i}", daemon=True).start()
        # wait for every shard; once one has failed, the others get at most
        # ``timeout`` seconds more to reach a collective and stop
        deadline, pending = None, n
        while pending:
            if deadline is None and any(e is not None for e in errors):
                deadline = time.monotonic() + self.timeout
            try:
                finished.get(timeout=None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                pending -= 1
            except queue.Empty:
                break
        failed = [e for e in errors if e is not None]
        if failed:
            primary = [e for e in failed if not isinstance(e, CollectiveError)]
            raise (primary or failed)[0]
        for i, ev in done.items():
            callers[self.devices[i]].wait_event(ev)
        return results


def make_mesh(n_devices: int | None = None, device="cuda", axis: str = "screen",
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh of ``n_devices`` shards. On the card (the default) shard i
    sits on ``cuda:{i % torch.cuda.device_count()}`` and ``n_devices``
    defaults to the card count; with ``device="cpu"`` every shard runs on
    the CPU and ``n_devices`` defaults to 1. No shard moves to the CPU on
    its own: without a card the default raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or count
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        n = n_devices or 1
        devices = (dev,) * n
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devices, axis, timeout)


# --------------------------------------------------------------------------
# sharded Forward+ frame
# --------------------------------------------------------------------------


def _local_pixel_rays(inv_vp, cam, h_local: int, width: int, row0: int, full_h: int):
    """(h_local, W, 3) unnormalised world rays of the slice's pixels in
    global rows: inv_vp @ (u * 2 - 1, 1 - 2 * v, 0.5, 1), homogenised,
    minus the camera; each row of the product a fixed-order 4-term sum."""
    dev = inv_vp.device
    ys = (torch.arange(h_local, dtype=torch.float32, device=dev) + row0 + 0.5) / full_h
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    ndc = (u * 2 - 1, 1 - 2 * v, torch.full_like(u, 0.5), torch.ones_like(u))
    m = inv_vp.to(torch.float32)
    p = [(m[r, 0] * ndc[0] + m[r, 1] * ndc[1]) + (m[r, 2] * ndc[2] + m[r, 3] * ndc[3])
         for r in range(4)]
    return torch.stack([p[i] / p[3] for i in range(3)], dim=-1) - cam


def _resolve_local(geometry, tri_setup, tid, rays, cam):
    """The G-buffer of a slice from its winners and precomputed rays:
    Moller-Trumbore u, v along each pixel's ray, clamped, and the vertex
    attributes interpolated (vertex colour as albedo, metallic 0,
    roughness 0.5)."""
    valid = tid >= 0
    rid = torch.clamp(tid, min=0).long()
    sid = tri_setup.src_id[rid].long()
    vidx = geometry.indices[sid].long()
    pos = geometry.position
    v0, v1, v2 = pos[vidx[..., 0]], pos[vidx[..., 1]], pos[vidx[..., 2]]
    e1, e2 = v1 - v0, v2 - v0
    pvec = m3.cross(rays, e2)
    det = m3.dot(e1, pvec, keepdims=True)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tvec = cam - v0
    u = torch.clamp(m3.dot(tvec, pvec, keepdims=True) * inv_det, 0.0, 1.0)
    qvec = m3.cross(tvec, e1)
    v = m3.dot(rays, qvec, keepdims=True) * inv_det
    v = torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)
    wgt = torch.cat([1.0 - u - v, u, v], dim=-1)

    def interp(attr):
        a = attr[vidx]                                    # (h, w, 3, C)
        return (a[..., 0, :] * wgt[..., 0:1] + a[..., 1, :] * wgt[..., 1:2]) \
            + a[..., 2, :] * wgt[..., 2:3]

    h, w = tid.shape
    dev = tid.device
    cov = valid.to(torch.float32)
    return pbr.GBuffer(
        world_position=interp(pos) * cov[..., None],
        normal=torch.where(valid[..., None], m3.normalize(interp(geometry.normal)),
                           torch.tensor([0.0, 0.0, 1.0], device=dev)),
        albedo=interp(geometry.color) * cov[..., None],
        metallic=torch.zeros(h, w, device=dev),
        roughness=torch.full((h, w), 0.5, device=dev),
        ao=torch.ones(h, w, device=dev),
        emissive=torch.zeros(h, w, 3, device=dev),
        coverage=cov,
    )


def _cull_local(lights, frame, lin_depth, h_local: int, width: int, row0: int,
                full_h: int, tile: int):
    """Light culling for a row slice: the local tiles' side planes from
    their global screen corners, a sphere test against each tile's widened
    depth slab, and each tile's k = min(32, capacity) nearest hit lights
    (directional lights first, ties by light id: a stable sort, as
    ``lax.top_k``). Returns (indices (Ty, Tx, k) -1 padded, counts)."""
    tiles_y = h_local // tile
    tiles_x = lin_depth.shape[1] // tile
    zmin, zmax = light_culling.tile_depth_bounds(lin_depth, tiles_y, tiles_x)
    diff = zmax - zmin
    z0, z1 = zmin - diff, zmax + diff
    dev = lin_depth.device
    xs = torch.arange(tiles_x + 1, dtype=torch.float32, device=dev) * tile
    ys = torch.arange(tiles_y + 1, dtype=torch.float32, device=dev) * tile + row0
    gy, gx = torch.meshgrid(1.0 - ys / full_h * 2.0, xs / width * 2.0 - 1.0, indexing="ij")
    corners = (gx, gy, torch.full_like(gx, 0.5), torch.ones_like(gx))
    m = frame.inv_projection.to(torch.float32)
    v = [(m[r, 0] * corners[0] + m[r, 1] * corners[1])
         + (m[r, 2] * corners[2] + m[r, 3] * corners[3]) for r in range(4)]
    rays = torch.stack([v[i] / v[3] for i in range(3)], dim=-1)
    tl, tr = rays[:-1, :-1], rays[:-1, 1:]
    bl, br = rays[1:, :-1], rays[1:, 1:]
    planes = m3.normalize(m3.cross(torch.stack([bl, tr, tl, br], dim=-2),
                                   torch.stack([tl, br, tr, bl], dim=-2)))  # (Ty, Tx, 4, 3)
    pos_vs = m3.transform_point(frame.view, lights.position)
    side = m3.dot(planes[..., None, :], pos_vs)                           # (Ty, Tx, 4, L)
    in_sides = torch.all(side >= -lights.radius, dim=2)
    z = -pos_vs[..., 2]
    in_depth = ((z + lights.radius >= z0[..., None]) & (z - lights.radius <= z1[..., None]))
    is_dir = lights.type == 0
    hit = ((in_sides & in_depth) | is_dir) & lights.valid_mask
    zc = (z0 + z1)[..., None] * 0.5
    d = torch.sqrt(pos_vs[..., 0] ** 2 + pos_vs[..., 1] ** 2 + (z - zc) ** 2)
    score = torch.where(hit, -torch.where(is_dir, torch.zeros_like(d), d),
                        torch.full_like(d, float("-inf")))
    k = min(32, lights.capacity)
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    live = torch.isfinite(vals)
    return torch.where(live, idx, -1).to(torch.int32), live.sum(-1).to(torch.int32)


def sharded_forward_frame(scene, *, width: int, height: int, mesh: Mesh,
                          capacity: int = 256, stats: dict | None = None):
    """A Forward+ frame split by pixel rows over ``mesh`` (the reference's
    ``sharded_forward_frame``). Each shard sets up every triangle against
    the whole viewport, shifts the setup into its rows
    (``setup.shift_viewport_rows``), drops the triangles outside its slice,
    bins them densely (``bin_all``, one round of ``capacity`` slots a tile),
    rasters each pass with B9 (``tile_raster.rasterize_tiles``) merging the
    passes by a strictly greater depth, resolves with its global pixel
    rays, culls lights on its tiles, shades (``pbr.shade_forward_plus``),
    adds its histogram to the others' (``psum``), and blooms and tonemaps
    the gathered frame. Each shard's slice of ``height // n`` rows must
    be whole tile rows (``tile_raster.TILE_H`` at the call), as the
    reference asks, or whole 32-row rows, which the port also admits at
    any tile height: a slice's last tile row is rastered padded and
    cropped, so 1920 x 1088 splits over 2 shards at the default 64. Returns the (H, W, 3) sRGB frame on the first shard's device.
    ``stats``, when given, receives "bin_overflow": the candidates each
    shard's binning dropped (a list in shard order)."""
    n = mesh.size
    th, tw = tile_raster.check_tile_h(), tile_raster.TILE_W
    if height % (n * th) and height % (n * 32):
        raise ValueError(f"height {height} must split into whole {th}-row tile rows "
                         f"(SAILOR_RASTER_TILE_H) or 32-row rows across {n} shards")
    h_local = height // n
    tiles_y = round_up(h_local, th) // th
    tiles_x = round_up(width, tw) // tw
    tile = cfg.LIGHTS_CULLING_TILE_SIZE

    def per_shard(comm):
        sc = replicate(scene, comm.device)
        row0 = comm.index * h_local
        frame = sc.frame
        inv_vp = m3.inverse(frame.view_projection)
        tri, (xmin, xmax, ymin, ymax) = rsetup.triangle_setup(
            sc.geometry, frame.view_projection, width=width, height=height, cull="back",
            zplane_rounding="standalone")
        tri_local = rsetup.shift_viewport_rows(tri, row0)
        # drop triangles outside the slice before binning: bin_all clamps
        # tile ranges into the slice, so an off-slice triangle would land in
        # a boundary tile row and take capacity from real geometry
        in_slice = (ymax >= row0) & (ymin < row0 + h_local)
        passes, overflow = rsetup.bin_all(
            tri_local.valid & in_slice, (xmin, xmax, ymin - row0, ymax - row0),
            tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tw, tile_h=th, capacity=capacity,
            rounds=1)
        depth = tid = None
        for bins, cnts in passes:
            d_r, t_r = tile_raster.rasterize_tiles(tri_local, bins, tiles_y=tiles_y,
                                                   tiles_x=tiles_x, counts=cnts)
            if depth is None:
                depth, tid = d_r, t_r
            else:
                take = d_r > depth
                depth = torch.where(take, d_r, depth)
                tid = torch.where(take, t_r, tid)
        depth, tid = depth[:h_local, :width], tid[:h_local, :width]
        rays = _local_pixel_rays(inv_vp, frame.camera_position, h_local, width, row0, height)
        gb = _resolve_local(sc.geometry, tri, tid, rays, frame.camera_position)
        znf = frame.camera_z_near_far
        lin = torch.where(depth > 0.0, znf[0] * znf[1] / (depth * (znf[1] - znf[0]) + znf[0]),
                          znf[1])
        pw = round_up(width, tile)
        plin = torch.nn.functional.pad(lin, (0, pw - width), value=1e4)
        lidx, _ = _cull_local(sc.lights, frame, plin, h_local, width, row0, height, tile)
        if pw != width:
            gb = gb.map(lambda x: torch.nn.functional.pad(
                x, [0, 0] * (x.ndim - 2) + [0, pw - width]))
        hdr = pbr.shade_forward_plus(gb, sc.lights, lidx, frame.camera_position)[:, :width]
        hist = comm.psum(hist_k.luminance_histogram(hdr))
        avg = hist_k.adapt_average_luminance(
            hist, torch.tensor(0.18, device=hdr.device), float(width * height),
            torch.tensor(10.0, device=hdr.device))
        full = comm.gather(hdr)
        ovf = comm.gather(overflow.reshape(1))
        if full is None:
            return None
        full = full + bloom_k.bloom(full, threshold=1.0, intensity=0.35)
        return m3.linear_to_srgb(tm.tonemap(full, avg, mode="aces")), ovf

    ldr, ovf = mesh.run(per_shard)[0]
    if stats is not None:
        stats["bin_overflow"] = [int(v) for v in ovf.cpu()]
    return ldr


def replicate(obj, device):
    """``obj`` with every tensor it holds on ``device``: dataclasses, lists,
    tuples and dicts are rebuilt around the moved tensors; anything else,
    and a tensor already there, is kept as it is."""
    if torch.is_tensor(obj):
        return obj if obj.device == device else obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: replicate(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(replicate(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: replicate(v, device) for k, v in obj.items()}
    return obj


# --------------------------------------------------------------------------
# sharded path tracer
# --------------------------------------------------------------------------


def shard_seed(seed: int, shard: int) -> int:
    """The generator seed of shard ``shard`` of a trace seeded ``seed``:
    ``seed * 1_000_003 + shard`` (the reference folds the shard index into
    its JAX key)."""
    return seed * 1_000_003 + shard


def global_rows_rays(camera_pos, view, proj, *, width: int, rows: range, height: int):
    """Unit primary rays through the centres of global pixel ``rows`` of a
    (height, width) frame, row-major: (origins, directions), each
    (len(rows) * W, 3), as ``sharded_path_trace`` makes them."""
    inv_vp = m3.inverse(proj.float() @ view.float()).to(camera_pos.device)
    rays = _local_pixel_rays(inv_vp, camera_pos.float(), len(rows), width, rows.start, height)
    d = m3.normalize(rays).reshape(-1, 3)
    return camera_pos.float().expand(d.shape).contiguous(), d


def sharded_path_trace(scene, camera_pos, view, proj, *, width: int, height: int,
                       mesh: Mesh, spp: int = 4, max_bounces: int = 2, seed: int = 0,
                       uniforms=None):
    """Path trace with the pixel rows split over ``mesh`` (the reference's
    ``sharded_path_trace``): each shard makes the unit rays of its rows
    (``global_rows_rays``), traces them with ``path_tracer.trace_rays``
    (B4/B5, or the BVH8 traversal by the port's routing) and the image is
    gathered in shard order. Samples: shard i's generator is seeded
    ``shard_seed(seed, i)``; with ``uniforms`` ((spp, 5 * max_bounces,
    H * W), row-major pixels) shard i takes its rows' columns, so the image
    equals ``trace_rays`` on all of ``global_rows_rays`` with the same
    uniforms. Returns the (H, W, 3) linear image on the first shard's
    device."""
    from sailor_tpu_torch.raytracing import path_tracer as pt

    n = mesh.size
    if height % n != 0:
        raise ValueError(f"height {height} does not split across {n} shards")
    h_local = height // n

    def per_shard(comm):
        dev = comm.device
        sc = replicate(scene, dev)
        row0 = comm.index * h_local
        o, d = global_rows_rays(camera_pos.to(dev), view.to(dev), proj.to(dev), width=width,
                                rows=range(row0, row0 + h_local), height=height)
        u = None
        if uniforms is not None:
            u = uniforms[..., row0 * width:(row0 + h_local) * width].to(dev)
        img, _ = pt.trace_rays(sc, o, d, spp=spp, max_bounces=max_bounces,
                               seed=shard_seed(seed, comm.index), uniforms=u)
        return comm.gather(img.reshape(h_local, width, 3))

    return mesh.run(per_shard)[0]
