#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sailor_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (nvcc); it imports nothing of JAX.

Phases, each printed as it ends:
  1. card: nvidia-smi's name and power limit, torch's device name;
  2. build: compile the CUDA kernels (sailor_tpu_torch/csrc) and load them;
  3. kernels: each kernel of the frame's path against its plain PyTorch
     version on the flagship frame's own inputs (1920x1088, 1001 lights,
     96 objects), with the tolerance stated, timed with CUDA events;
  4. frame: the flagship scene through FrameGraph with the minimal graph
     (DepthPrepass -> LinearizeDepth -> LightCulling -> RenderScene ->
     EyeAdaptation): 1 warm-up + 5 frames with the state threaded through;
     launch counts of that run, frame and per-node times, peak memory, one
     profiled frame, the per-node cost of the float64 fused multiply-add
     emulation (core.math3d.fma); the output is checked (finite, in [0, 1], coverage > 0) and a 256x128
     frame on the card is held against the same frame on the CPU path.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure ends the run with
a non-zero exit code and no result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FLAGSHIP = (1920, 1088, 1000, 96)  # width, height, point lights, objects
SLICE_CONFIG = {
    "z_far": 150.0, "bin_capacity": 1024, "bin_rounds": 4,
    "max_lights_per_tile": 128, "pallas_shading": True, "fused_resolve": True,
    "raster_mode": "stream", "raster_worklist": True,
    "light_coarse_capacity": 256, "hiz_culling": False, "tonemap": "aces",
    "ldr_dither": True,
}
MINIMAL_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling",
                 "RenderScene", "EyeAdaptation"]
# H100 SXM published peaks (NVIDIA data sheet), used for the bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def check(ok: bool, what: str) -> None:
    """Fail the run (an exception, so the exit code is not 0) unless ok."""
    if not ok:
        raise RuntimeError(what)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn) -> tuple[float, object]:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _span(lo, hi, first, last):
    """Per row, the count of pixel indices i in [first, last] whose centre
    i + 0.5 passes the raster's AABB test lo - 0.05 <= i + 0.5 <= hi + 0.05."""
    import torch

    a = torch.maximum(torch.ceil(lo.double() - 0.55), first)
    b = torch.minimum(torch.floor(hi.double() - 0.45), last)
    return torch.clamp(b - a + 1, min=0)


def raster_work(rows, big_rows, starts, counts, n_big, tiles_y, tiles_x):
    """What B1 must do on this data: (candidate rows, (pixel, candidate)
    pairs). A tile's live rows are tested only at the tile's pixels inside
    the row's screen AABB (every other pixel fails the AABB clamp), the big
    list at the screen's pixels inside its AABB."""
    import torch

    from sailor_tpu_torch.raster import tile_raster as tr

    dev = rows.device
    c = counts.long()
    tile = torch.repeat_interleave(torch.arange(c.numel(), device=dev), c)
    first = torch.cumsum(c, 0) - c
    idx = starts.long()[tile] + torch.arange(tile.numel(), device=dev) - first[tile]
    r = rows[idx]
    x0 = (tile % tiles_x).double() * tr.TILE_W
    y0 = (tile // tiles_x).double() * tr.TILE_H
    live = r[:, 16] >= 0
    pairs = (_span(r[:, 12], r[:, 13], x0, x0 + tr.TILE_W - 1)
             * _span(r[:, 14], r[:, 15], y0, y0 + tr.TILE_H - 1))[live].sum()
    b = big_rows[:int(n_big)]
    zero = torch.zeros(b.shape[0], dtype=torch.float64, device=dev)
    big_live = b[:, 16] >= 0
    pairs += (_span(b[:, 12], b[:, 13], zero, zero + tiles_x * tr.TILE_W - 1)
              * _span(b[:, 14], b[:, 15], zero, zero + tiles_y * tr.TILE_H - 1))[big_live].sum()
    return int(live.sum()) + int(big_live.sum()), int(pairs)


def frame_inputs(scene, width, height):
    """The flagship frame's own kernel inputs, made by the graph's nodes."""
    from sailor_tpu_torch.framegraph import nodes as nodes_mod
    from sailor_tpu_torch.framegraph.graph import RenderContext, node_types
    from sailor_tpu_torch.raster import interpolate, tile_raster

    nodes = node_types()
    ctx = RenderContext(width=width, height=height, scene=scene, state={},
                        values={}, config=dict(SLICE_CONFIG))
    targets = {}
    for name in ("DepthPrepass", "LinearizeDepth", "LightCulling"):
        targets = nodes[name]().process(ctx, targets)
    sb = targets["StreamBins"][0]
    tw, th = tile_raster.TILE_W, tile_raster.TILE_H
    tiles_y, tiles_x = -(-height // th), -(-width // tw)
    inv_vp = nodes_mod.inverse_view_projection(scene.frame)
    gbuffer, _, _ = interpolate.resolve_gbuffer_stream(
        sb, targets["TriId"], inv_vp, scene.frame.camera_position,
        width=width, height=height, tiles_y=tiles_y, tiles_x=tiles_x)
    return sb, targets, inv_vp, gbuffer, tiles_y, tiles_x


def check_kernels(scene, width, height, card):
    import torch

    from sailor_tpu_torch.kernels import pbr_kernel
    from sailor_tpu_torch.raster import tile_raster as tr

    sb, targets, inv_vp, gb, tiles_y, tiles_x = frame_inputs(scene, width, height)
    rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                        sb["counts"], sb["n_big"])
    results = []
    npix = tiles_y * tr.TILE_H * tiles_x * tr.TILE_W

    # ---- B1 raster: exact arithmetic twin; depth <= 1e-6, tid mismatches <= 16
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    d_k, t_k = tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, **kw)
    plain_ms, (d_p, t_p) = _wall_ms(
        lambda: tr.rasterize_worklist_plain(rows, big, starts, counts, n_big, **kw))
    ms = _time_ms(lambda: tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big, **kw), 10)
    err = (d_k - d_p).abs().max().item()
    mism = int((t_k != t_p).sum())
    cand, pairs = raster_work(rows, big, starts, counts, n_big, tiles_y, tiles_x)
    # candidate rows' 17 raster columns read once, starts and counts, depth
    # and tid written; 16 flops per (pixel, candidate) pair: 4 planes of
    # fma + mul + add (an fma counts as two)
    bound, by = _bound(cand * 17 * 4 + counts.numel() * 8 + npix * 8, pairs * 16)
    print(f"kernel raster_worklist: max_abs_err(depth)={err:.3g} tid_mismatch={mism} "
          f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound:.5f} ({by}) "
          f"candidates={cand} pairs={pairs} at {width}x{height} on {card}")
    check(err <= 1e-6 and mism <= 16, "raster kernel disagrees with its plain version")
    results.append(dict(name="raster_worklist", source="sailor_tpu_torch/csrc/raster.cu",
                        replaces="sailor_tpu/raster/tile_raster.py:442",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by))

    # ---- B2 resolve (full mode, 37 attribute columns): <= 1e-5 on all but
    # 1e-5 of values, and every value within 1e-4 * (1 + |plain|)
    tid = t_k.contiguous()
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, width, height, 0, rows.device)
    kw2 = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=int(sb["na"]), chunk=int(sb["chunk"]))
    p_k = torch.stack(tr.resolve_worklist_cuda(rows, big, tid, starts, counts, par, **kw2))
    plain_ms, p_p = _wall_ms(lambda: torch.stack(
        tr.resolve_worklist_plain(rows, big, tid, starts, counts, par, **kw2)))
    ms = _time_ms(lambda: tr.resolve_worklist_cuda(rows, big, tid, starts, counts, par, **kw2), 20)
    diff = (p_k - p_p).abs()
    err = diff.max().item()
    frac = (diff > 1e-5).float().mean().item()
    winners = int(torch.unique(tid[tid >= 0]).numel())
    n_out = p_k.shape[0]
    flops = int((tid >= 0).sum()) * 115  # ray, barycentrics, 12 lerps per pixel
    bound, by = _bound(npix * 4 + winners * (1 + sb["na"]) * 4 + npix * n_out * 4, flops)
    print(f"kernel resolve_worklist: max_abs_err={err:.3g} frac_err>1e-5={frac:.3g} "
          f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound:.4f} ({by}) on {card}")
    check(frac <= 1e-5 and bool((diff <= 1e-4 * (1 + p_p.abs())).all()),
          "resolve kernel disagrees with its plain version")
    results.append(dict(name="resolve_worklist", source="sailor_tpu_torch/csrc/resolve.cu",
                        replaces="sailor_tpu/raster/tile_raster.py:1310",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by))

    # ---- B3 shade: relative 1e-5 (same operation order; rsqrt may differ by an ulp)
    lp = pbr_kernel.pack_tile_lights(scene.lights, targets["LightIndices"])
    lc = targets["LightCounts"].to(torch.int32).contiguous()
    cam = scene.frame.camera_position.to(torch.float32).contiguous()
    args = (lp, lc, gb.albedo.contiguous(), gb.metallic.contiguous(),
            gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), None, cam)
    c_k = pbr_kernel.shade_tiles_cuda(*args)
    plain_ms, c_p = _wall_ms(lambda: pbr_kernel.shade_tiles_plain(*args))
    ms = _time_ms(lambda: pbr_kernel.shade_tiles_cuda(*args), 20)
    err = (c_k - c_p).abs().max().item()
    rel = ((c_k - c_p).abs() / c_p.abs().clamp(min=1e-3)).max().item()
    pairs = int(lc.sum()) * 256  # (pixel, live light) pairs
    # G-buffer read (48 B) and radiance written (12 B) per pixel, live light
    # rows once; ~130 flops per (pixel, light) in the loop body
    bound, by = _bound(gb.metallic.numel() * 60 + int(lc.sum()) * 64 + lc.numel() * 4,
                       pairs * 130)
    print(f"kernel shade_forward_plus: max_abs_err={err:.3g} max_rel_err={rel:.3g} "
          f"ms={ms:.4f} plain_ms={plain_ms:.1f} bound_ms={bound:.4f} ({by}) "
          f"mean_lights_per_tile={lc.float().mean().item():.2f} on {card}")
    check(rel <= 1e-5, "shade kernel disagrees with its plain version")
    results.append(dict(name="shade_forward_plus", source="sailor_tpu_torch/csrc/shade.cu",
                        replaces="sailor_tpu/kernels/pbr_pallas.py:48",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by))
    for r in results:
        r.update(route="cuda", library_ms=None)  # no single PyTorch call computes these
    return results


def run_frames(scene, width, height, card):
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.kernels import cuda_lib

    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), width, height,
                    dict(SLICE_CONFIG))
    state = fg.initial_state()
    fg.prepare(scene, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    warm_ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
    frame_ms = []
    for _ in range(5):
        ms, (targets, state) = _wall_ms(lambda: fg.process(scene, state))
        frame_ms.append(ms)
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, _, per_node = fg.process_debug(scene, state)
    fma_cost(fg, scene, state, card)
    profile_frame(fg, scene, state, card)  # last: frames after it run slower
    print(f"frame {width}x{height}: warmup_ms={warm_ms:.2f} "
          f"frame_ms={[round(m, 3) for m in frame_ms]} "
          f"mean_ms={sum(frame_ms) / len(frame_ms):.3f} peak_mem_bytes={peak} on {card}")
    print("per_node_ms " + json.dumps({k: round(v, 3) for k, v in per_node.items()}))
    print("launches " + json.dumps(launches))
    for name in ("raster_worklist", "resolve_worklist", "shade_forward_plus"):
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
    final = targets["Final"]
    cov = (targets["TriId"] >= 0).float().mean().item()
    check(tuple(final.shape) == (height, width, 3), f"Final has shape {tuple(final.shape)}")
    check(bool(torch.isfinite(final).all()), "Final has non-finite values")
    check(final.min().item() >= 0.0 and final.max().item() <= 1.0, "Final leaves [0, 1]")
    check(cov > 0.0, "nothing was rasterized")
    print(f"output: Final in [{final.min().item():.4f}, {final.max().item():.4f}] "
          f"coverage={cov:.4f} avg_luminance={state['avg_luminance'].item():.5f}")
    return launches


def profile_frame(fg, scene, state, card):
    """One frame under torch.profiler: device busy share of the frame's
    wall time (union of kernel intervals) and device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms, _ = _wall_ms(lambda: fg.process(scene, state))
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print("profile: the profiler recorded no device events")
        return
    busy, end = 0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: wall_ms={wall_ms:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"device_idle_share={1 - busy / 1e3 / wall_ms:.3f} kernels={len(spans)} on {card}")
    print("profile_top_device_us " + json.dumps({k[:60]: v for k, v in top}))


def fma_cost(fg, scene, state, card, reps: int = 4):
    """What the float64 fused multiply-add (core.math3d.fma) costs the
    frame: per-node ms, the least of `reps` synchronised frames, with it and
    with an unfused float32 a * b + c in its place (runs interleaved). The
    unfused frames round otherwise and are discarded."""
    from sailor_tpu_torch.core import math3d
    from sailor_tpu_torch.raster import setup

    fused = math3d.fma
    variants = {"float64_fma": fused, "float32_unfused": lambda a, b, c: a * b + c}
    best = {k: {} for k in variants}
    try:
        for i in range(2 * reps):
            name = list(variants)[(i + i // 2) % 2]  # A B B A ...
            math3d.fma = setup.fma = variants[name]
            _, _, per_node = fg.process_debug(scene, state)
            for node, ms in per_node.items():
                best[name][node] = min(ms, best[name].get(node, float("inf")))
    finally:
        math3d.fma = setup.fma = fused
    for name, nodes in best.items():
        print(f"fma_cost {name}: " + json.dumps({k: round(v, 3) for k, v in nodes.items()})
              + f" on {card}")


def check_small_frame():
    """A 256x128 frame on the card against the same frame on the CPU path
    (which the CPU tests hold to the JAX package): TriId equal on >= 99.9%
    of pixels, Final within 2/255 on >= 99.9%."""
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
    from sailor_tpu_torch.scenes import flagship_scene

    out = {}
    for dev in ("cuda", "cpu"):
        scene = flagship_scene(256, 128, 24, 10, device=dev)
        fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 256, 128,
                        dict(SLICE_CONFIG), device=dev)
        t, _ = fg.process(scene, fg.initial_state())
        out[dev] = {k: t[k].cpu() for k in ("TriId", "Final")}
    same = (out["cuda"]["TriId"] == out["cpu"]["TriId"]).float().mean().item()
    close = ((out["cuda"]["Final"] - out["cpu"]["Final"]).abs().amax(-1)
             <= 2 / 255).float().mean().item()
    print(f"small frame card vs cpu: tid_equal={same:.5f} final_within_2/255={close:.5f}")
    check(same >= 0.999 and close >= 0.999, "card frame disagrees with the CPU path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import flagship_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    width, height, n_lights, n_objects = FLAGSHIP
    scene = flagship_scene(width, height, n_lights, n_objects)
    print(f"scene: {scene.geometry.indices.shape[0]} triangles, "
          f"{scene.lights.num} lights, {width}x{height}")
    kernels = check_kernels(scene, width, height, card)
    launches = run_frames(scene, width, height, card)
    check_small_frame()
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
