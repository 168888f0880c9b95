"""Two checkouts of the port on one NVIDIA GPU, in turns (A, B, B, A), on
the same inputs: the intersector's table build (``sweep._tables``: B4 and
whatever builds the sweeps' visit tables around it) and B4's own kernel
(``slab_entry_cuda`` where the checkout has it, else
``visit_tables_cuda``) on the bench tracer scene's rays (512x512:
bounce-0 and bounce-1 rays of one sample and their shadow rays), and B7
in both plane forms (``rasterize_stream_cuda``), B8
(``rasterize_dma_cuda``) and B9 on the flagship frame (1920x1088, 1000
point lights, 96 objects): B9's kernel alone on each pass of the dense
frame, with and without the AABB clamp (``rasterize_tiles_cuda`` on the
per-triangle table where the checkout has ``dense_table``, else on the
gathered rows of ``dense_rows``), the entry ``rasterize_tiles`` on each
pass (its row table or gather included) and ``pipeline.raster_merge``
over the five passes (with its kernels counted). Not a test (it is not
collected): a measurement for comparing a change with its parent.

    python tests/torch_compare_checkouts.py PATH_A PATH_B
    python tests/torch_compare_checkouts.py --raster [--rounds N] PATH_A PATH_B

``--raster`` times the frame's raster and resolve kernels alone, on the
flagship frame's own inputs at the tile height of the environment
(``SAILOR_RASTER_TILE_H``, 64 by default): B1 and B2 on the work-list
rows, B7 in both plane forms and B10 on windows of 256 (kmax 16), B8 on
windows of 128, B9 on the dense frame's first pass with the AABB clamp;
each kernel's device time a call is the sum of its kernels' device
events in a torch.profiler session of 20 calls (B1, B7-B9: the plan and
the raster kernel), the runs in turns (A, B, B, A) ``--rounds`` times
(default 1).

Each run is a fresh process that imports the package of its checkout
(which builds its kernels into its own build/). Times are device times:
CUDA events around 20 calls queued while the card sleeps, so the host's
launch time is not in them; kernels a call are counted with torch.profiler.
Each run prints one JSON line.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.raster import pipeline
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.raytracing import sweep
from sailor_tpu_torch.scenes import flagship_scene, tracer_scene


def device_ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * 10**6)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernels(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


cuda_lib.load()
out = {"checkout": sys.argv[1]}
scene, cam, view, proj = tracer_scene()
passes = chip_smoke.tracer_passes(scene, cam, view, proj, 512, 512)
for name, p in zip(["bounce0", "bounce0_shadow", "bounce1", "bounce1_shadow"], passes):
    o, d = p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous()
    call = lambda: sweep._tables(scene.sweep, o, d, p["tmax"])
    out[f"tables_ms[{name}]"] = device_ms(call)
    out[f"tables_kernels[{name}]"] = kernels(call)
    if hasattr(sweep, "slab_entry_cuda"):  # B4 alone, before it wrote the tables
        b4 = lambda: sweep.slab_entry_cuda(p["feats"], p["tmax"], scene.sweep.cl_min,
                                           scene.sweep.cl_max)
    else:
        b4 = lambda: sweep.visit_tables_cuda(o, d, p["tmax"], scene.sweep.cl_min,
                                             scene.sweep.cl_max)
    out[f"b4_ms[{name}]"] = device_ms(b4)
del scene, passes
w, h, lights, objects = chip_smoke.FLAGSHIP
fs = flagship_scene(w, h, lights, objects)
_, targets, _, _, tiles_y, tiles_x = chip_smoke.frame_inputs(fs, w, h)
tri, aabb = targets["TriSetup"], targets["TriAABB"]
order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
    tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
rows, big, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=256)
c0, spt, _ = tr.stream_windows(starts, counts, 256, 16)
n_big = n_big.to(torch.int32).reshape(())
for mxu in (False, True):
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=256, mxu=mxu)
    out["raster_stream_mxu_ms" if mxu else "raster_stream_ms"] = device_ms(
        lambda: tr.rasterize_stream_cuda(rows, big, c0, spt, n_big, **kw))
rows8, big8, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=128)
w0, nw = tr.dma_windows(starts, counts, 128)
out["raster_dma_ms"] = device_ms(lambda: tr.rasterize_dma_cuda(
    rows8, big8, w0, nw, n_big, tiles_y=tiles_y, tiles_x=tiles_x, dchunk=128))
dtri, daabb = rsetup.triangle_setup(fs.geometry, fs.frame.view_projection, width=w, height=h,
                                    zplane_rounding="standalone")
cfg = chip_smoke.SLICE_CONFIG
passes, _ = rsetup.bin_all(dtri.valid, daabb, tiles_x=tiles_x, tiles_y=tiles_y,
                           tile_w=tr.TILE_W, tile_h=tr.TILE_H, capacity=cfg["bin_capacity"],
                           rounds=cfg["bin_rounds"])
kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
names = ["first"] + [f"round{i + 1}" for i in range(1, len(passes) - 1)] + ["big_pass"]
for clamp in (True, False):
    box = daabb if clamp else None
    tag = "" if clamp else ",no_aabb"
    for pname, (bins, pcounts) in zip(names, passes):
        ids = bins.reshape(-1).to(torch.int32).contiguous()
        pc = pcounts.reshape(-1).to(torch.int32).contiguous()
        if hasattr(tr, "dense_table"):
            src = tr.dense_table(dtri, box)
        else:  # the parent's gathered rows and ids
            src, ids = tr.dense_rows(dtri, bins, box)
        out[f"raster_dense_ms[{pname}{tag}]"] = device_ms(
            lambda: tr.rasterize_tiles_cuda(src, ids, pc, **kw))
        out[f"rasterize_tiles_ms[{pname}{tag}]"] = device_ms(
            lambda: tr.rasterize_tiles(dtri, bins, counts=pcounts, screen_aabb=box, **kw))
    merge = lambda: pipeline.raster_merge(dtri, passes, tiles_y, tiles_x, screen_aabb=box)
    out[f"raster_merge_ms[{'aabb' if clamp else 'no_aabb'}]"] = device_ms(merge)
    out[f"raster_merge_kernels[{'aabb' if clamp else 'no_aabb'}]"] = kernels(merge)
out["card"] = chip_smoke._card()
print(json.dumps(out))
'''


RASTER_CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.raster import setup as rsetup
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.scenes import flagship_scene


def device_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "(anonymous namespace)::" in e.name]
    return sum(us) / reps / 1e3


cuda_lib.load()
out = {"checkout": sys.argv[1], "tile_h": tr.TILE_H}
w, h, lights, objects = chip_smoke.FLAGSHIP
fs = flagship_scene(w, h, lights, objects)
sb, targets, inv_vp, _, tiles_y, tiles_x = chip_smoke.frame_inputs(fs, w, h)
kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)
rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"], sb["counts"],
                                    sb["n_big"])
out["raster_worklist"] = device_ms(lambda: tr.rasterize_worklist_cuda(
    rows, big, starts, counts, n_big, chunk=128, **kw))
tid = tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, chunk=128, **kw)[1]
par = tr._resolve_params(inv_vp, fs.frame.camera_position, w, h, 0, rows.device)
out["resolve_worklist"] = device_ms(lambda: tr.resolve_worklist_cuda(
    rows, big, tid, starts, counts, par, na=int(sb["na"]), chunk=int(sb["chunk"]), **kw))
tri, aabb = targets["TriSetup"], targets["TriAABB"]
order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
    tri.valid, aabb, tile_w=tr.TILE_W, tile_h=tr.TILE_H, **kw)
n_big = n_big.to(torch.int32).reshape(())
attrs = fs.attrs_packed[tri.src_id.long()]
rows, big, na = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=attrs, chunk=256)
c0, spt, _ = tr.stream_windows(starts, counts, 256, 16)
for mxu in (False, True):
    out["raster_stream_mxu" if mxu else "raster_stream"] = device_ms(
        lambda: tr.rasterize_stream_cuda(rows, big, c0, spt, n_big, chunk=256, mxu=mxu, **kw))
tid = tr.rasterize_stream_cuda(rows, big, c0, spt, n_big, chunk=256, **kw)[1]
out["resolve_stream"] = device_ms(lambda: tr.resolve_stream_cuda(
    rows, big, tid, starts, counts, c0, spt, par, na=na, chunk=256, **kw))
rows8, big8, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=128)
w0, nw = tr.dma_windows(starts, counts, 128)
out["raster_dma"] = device_ms(lambda: tr.rasterize_dma_cuda(
    rows8, big8, w0, nw, n_big, dchunk=128, **kw))
dtri, daabb = rsetup.triangle_setup(fs.geometry, fs.frame.view_projection, width=w, height=h,
                                    zplane_rounding="standalone")
cfg = chip_smoke.SLICE_CONFIG
passes, _ = rsetup.bin_all(dtri.valid, daabb, tile_w=tr.TILE_W, tile_h=tr.TILE_H,
                           capacity=cfg["bin_capacity"], rounds=cfg["bin_rounds"], **kw)
bins, pcounts = passes[0]
table = tr.dense_table(dtri, daabb)
ids = bins.reshape(-1).to(torch.int32).contiguous()
pc = pcounts.reshape(-1).to(torch.int32).contiguous()
out["raster_dense"] = device_ms(lambda: tr.rasterize_tiles_cuda(table, ids, pc, **kw))
out["card"] = chip_smoke._card()
print(json.dumps(out))
'''


def main():
    args = sys.argv[1:]
    child, rounds = CHILD, 1
    if args[:1] == ["--raster"]:
        child, args = RASTER_CHILD, args[1:]
        if args[:1] == ["--rounds"]:
            rounds, args = int(args[1]), args[2:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(p) for p in args)
    for path in (a, b, b, a) * rounds:
        run = subprocess.run([sys.executable, "-c", child, path], cwd=path,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
        if run.returncode:
            print(run.stdout[-4000:], file=sys.stderr)
            return run.returncode
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
