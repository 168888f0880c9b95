"""B1, B3, B4, B7, B8 and B9 beside variants of themselves on one NVIDIA GPU, on
the flagship frame's own inputs (1920x1088, 1000 point lights, 96 objects)
and, for B4, on the bench tracer scene's bounce-1 rays (512x512). Each
variant is the kernel's source under csrc/ with one design choice undone
by a text edit, built with the same nvcc flags into build/variants/; each
is timed with CUDA events (50 launches after a warm-up) and held bit for
bit to the kernel as built. Not a test (it is not collected): a
measurement behind the design notes in csrc/raster.cu, csrc/shade.cu and
csrc/slab_entry.cu.

    python tests/torch_kernel_variants.py

B1 variants: R (groups a run) 2 and 8 beside 4; every group's
(rectangle, row) pairs balanced over the warps, or never (each warp its own
rows); three blocks an SM in place of four. B7 (the same kernel over the
stream windows): R 8, 16 and 32 groups of 32 rows, and for the MXU form R
2, 4 and 8 groups of 128, each with scratch for every run, beside the
wrapper (runs of STREAM_RUN_ROWS = 512 rows). B8 (the same kernel over
each tile's window span) and B9 (over each tile's bin slots, rows read by
id: every pass of the dense frame, with and without the AABB clamp) at
their wrappers' run lengths (DMA_RUN_ROWS, DENSE_RUN_ROWS), at half and
at twice that, each with the wrapper's scratch (R doubles where the split
tiles' runs do not fit; the R the plan takes is printed). B3 variants:
torch.clamp's max as three instructions (sailor::clamp_lo) in place of
one; rsqrtf with its subnormal rescaling; five blocks an SM; __frcp_rn's
range check on each of a pair's three reciprocals in place of one check
for all three. B4 variant: 2 rays a thread (1024 threads) in place of 4
(the other block layout once timed, one block a sub-block, was a patch of
the fixed-size kernel and is no longer built; csrc/slab_entry.cu keeps its
times).
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sailor_tpu_torch.kernels import cuda_lib, pbr_kernel  # noqa: E402
from sailor_tpu_torch.raster import tile_raster as tr  # noqa: E402
from sailor_tpu_torch.scenes import flagship_scene  # noqa: E402

CSRC = os.path.join(ROOT, "sailor_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")

RASTER_LB = ("__global__ void __launch_bounds__(THREADS, 4)\nraster_runs_kernel",
             "__global__ void __launch_bounds__(THREADS, 3)\nraster_runs_kernel")
BALANCE = "  if (most * WARPS <= 2 * total + 4 * WARPS) {"
RASTER = {
    "as built": [],
    "always balanced": [(BALANCE, "  if (false) {")],
    "never balanced": [(BALANCE, "  if (true) {")],
    "3 blocks an SM": [RASTER_LB],
}
# 2 rays a thread, 1024 threads a block (the group of 2,048 rays kept)
RPT = [("constexpr int RPT = 4;", "constexpr int RPT = 2;"),
       ("constexpr int THREADS = 512;", "constexpr int THREADS = 1024;")]
SLAB = {
    "as built": [],
    "2 rays a thread": RPT,
}
SHADE = {
    "as built": [],
    "3-instruction clamp": [
        ("  asm(\"max.NaN.f32 %0, %1, %2;\" : \"=f\"(d) : \"f\"(a), \"f\"(b));\n  return d;",
         "  return a != a ? a : fmaxf(a, b);"),
        ("  asm(\"min.NaN.f32 %0, %1, %2;\" : \"=f\"(d) : \"f\"(a), \"f\"(b));\n  return d;",
         "  return a != a ? a : fminf(a, b);")],
    "rsqrtf": [("  asm(\"rsqrt.approx.ftz.f32 %0, %1;\" : \"=f\"(d) : \"f\"(x));\n  return d;",
                "  return rsqrtf(x);")],
    "5 blocks an SM": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 5)")],
    "range check a reciprocal": [
        ("  if (in_rcp_range(a) & in_rcp_range(b) & in_rcp_range(c)) {", "  if (false) {")],
}


def build(kernel, name, edits):
    """Start nvcc on csrc/<kernel> with `edits` applied; (process, library)."""
    src = open(os.path.join(CSRC, kernel)).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{kernel} [{name}]: the source no longer has {old!r}")
        src = src.replace(old, new)
    label = name.replace(",", "").replace(" ", "_")
    stem = os.path.join(OUT, kernel.replace(".cu", "") + "_" + label)
    with open(stem + ".cu", "w") as f:
        f.write(src)
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", CSRC, "-shared", stem + ".cu",
           "-o", stem + ".so"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), stem + ".so"


def load(proc, path, label):
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {label}:\n{out}")
    regs = "; ".join(line.split(":", 1)[1].strip() for line in out.splitlines()
                     if "registers" in line)
    lib = ctypes.CDLL(path)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib, regs


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device and nvcc", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    procs = {("raster.cu", k): build("raster.cu", k, e) for k, e in RASTER.items()}
    procs.update({("shade.cu", k): build("shade.cu", k, e) for k, e in SHADE.items()})
    procs.update({("slab_entry.cu", k): build("slab_entry.cu", k, e) for k, e in SLAB.items()})
    cuda_lib.load()
    libs = {key: load(*procs[key], key) for key in procs}
    card = chip_smoke._card()
    width, height, lights, objects = chip_smoke.FLAGSHIP
    scene = flagship_scene(width, height, lights, objects)
    sb, targets, _inv_vp, gb, tiles_y, tiles_x = chip_smoke.frame_inputs(scene, width, height)
    stream = torch.cuda.current_stream().cuda_stream

    rows, big, starts, counts, n_big = (sb["rows"], sb["big_rows"], sb["starts"],
                                        sb["counts"], sb["n_big"])
    d_ref, t_ref = tr.rasterize_worklist_cuda(rows, big, starts, counts, n_big,
                                              tiles_y=tiles_y, tiles_x=tiles_x)
    ntiles = tiles_y * tiles_x
    for (kernel, name), (lib, regs) in libs.items():
        if kernel != "raster.cu":
            continue
        for groups in ((2, 4, 8) if name == "as built" else (tr.RUN_GROUPS,)):
            slots = tr.worklist_slots(ntiles) * max(1, tr.RUN_GROUPS // groups)
            ws = torch.empty(tr._worklist_workspace(ntiles, slots), dtype=torch.int32,
                             device="cuda")
            depth, tid = torch.empty_like(d_ref), torch.empty_like(t_ref)

            def run():
                cuda_lib.check(lib.sailor_raster_worklist(
                    rows.data_ptr(), rows.shape[1], big.data_ptr(), big.shape[0],
                    n_big.data_ptr(), starts.data_ptr(), counts.data_ptr(), None, None,
                    depth.data_ptr(), tid.data_ptr(), tiles_y, tiles_x, tr.TILE_H, groups,
                    slots, ws.data_ptr(), stream), name)

            ms = chip_smoke._time_ms(run, 50)
            same = bool(torch.equal(depth, d_ref)) and bool(torch.equal(tid, t_ref))
            print(f"raster_worklist [{name}, R={groups}]: ms={ms:.4f} bit_equal={same} "
                  f"ptxas: {regs} on {card}", flush=True)
    stream_run_lengths(libs[("raster.cu", "as built")][0], scene, targets, tiles_y, tiles_x,
                       card, stream)
    span_run_lengths(libs[("raster.cu", "as built")][0], scene, targets, tiles_y, tiles_x,
                     card, stream)

    table = pbr_kernel.pack_lights(scene.lights)
    idx = targets["LightIndices"].to(torch.int32).contiguous()
    lc = targets["LightCounts"].to(torch.int32).contiguous()
    cam = scene.frame.camera_position.to(torch.float32).contiguous()
    g = [gb.albedo.contiguous(), gb.metallic.contiguous(), gb.roughness.contiguous(),
         gb.normal.contiguous(), gb.world_position.contiguous()]
    c_ref = pbr_kernel.shade_tiles_cuda(table, idx, lc, *g, None, cam)
    H, W = gb.metallic.shape
    for (kernel, name), (lib, regs) in libs.items():
        if kernel != "shade.cu":
            continue
        out = torch.empty_like(c_ref)

        def run():
            cuda_lib.check(lib.sailor_shade_forward_plus(
                table.data_ptr(), table.shape[0] - 1, idx.data_ptr(), lc.data_ptr(),
                *(t.data_ptr() for t in g), None, cam.data_ptr(), out.data_ptr(),
                idx.shape[-1], H, W, stream), name)

        ms = chip_smoke._time_ms(run, 50)
        print(f"shade_forward_plus [{name}]: ms={ms:.4f} bit_equal={bool(torch.equal(out, c_ref))} "
              f"ptxas: {regs} on {card}", flush=True)
    del scene, sb, targets, gb
    slab_variants({k[1]: v for k, v in libs.items() if k[0] == "slab_entry.cu"}, card, stream)
    return 0


def stream_run_lengths(lib, scene, targets, tiles_y, tiles_x, card, stream):
    """B7 in both forms at several run lengths R, with scratch for every
    run, against the wrapper (R from tile_raster.STREAM_RUN_ROWS)."""
    from sailor_tpu_torch.raster import setup as rsetup

    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    chunk = 256
    kmax = chip_smoke.SLICE_CONFIG["bin_capacity"] * chip_smoke.SLICE_CONFIG["bin_rounds"] // chunk
    rows, big, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=chunk)
    c0, spt, _ = tr.stream_windows(starts, counts, chunk, kmax)
    n_big = n_big.to(torch.int32).reshape(())
    ntiles = tiles_y * tiles_x
    slots = 8 * ntiles
    ws = torch.empty(tr._worklist_workspace(ntiles, slots), dtype=torch.int32, device="cuda")
    for mxu, run_groups in ((False, (8, 16, 32)), (True, (2, 4, 8))):
        kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=chunk, mxu=mxu)
        d_ref, t_ref = tr.rasterize_stream_cuda(rows, big, c0, spt, n_big, **kw)
        wrapper_ms = chip_smoke._time_ms(
            lambda: tr.rasterize_stream_cuda(rows, big, c0, spt, n_big, **kw), 50)
        name = "raster_stream_mxu" if mxu else "raster_stream"
        print(f"{name} [wrapper, its scratch]: ms={wrapper_ms:.4f} on {card}", flush=True)
        for groups in run_groups:
            depth, tid = torch.empty_like(d_ref), torch.empty_like(t_ref)

            def run():
                cuda_lib.check(lib.sailor_raster_stream(
                    rows.data_ptr(), rows.shape[1], big.data_ptr(), big.shape[0],
                    n_big.data_ptr(), c0.data_ptr(), spt.data_ptr(), None, None,
                    depth.data_ptr(), tid.data_ptr(), tiles_y, tiles_x, tr.TILE_H, chunk,
                    int(mxu), groups, slots, ws.data_ptr(), stream), name)

            ms = chip_smoke._time_ms(run, 50)
            same = bool(torch.equal(depth, d_ref)) and bool(torch.equal(tid, t_ref))
            print(f"{name} [R={groups}, scratch for {slots} runs]: ms={ms:.4f} "
                  f"bit_equal={same} on {card}", flush=True)


def span_run_lengths(lib, scene, targets, tiles_y, tiles_x, card, stream):
    """B8 on the flagship frame's rows (windows of 128) and B9 on each pass
    of its dense frame (SLICE_CONFIG's capacity and rounds, the dense
    path's setup), at half, once and twice the wrapper's run length, with
    the wrapper's scratch, held bit for bit to the wrapper."""
    from sailor_tpu_torch.raster import setup as rsetup

    ntiles = tiles_y * tiles_x
    slots = tr.worklist_slots(ntiles)
    ws = torch.empty(tr._worklist_workspace(ntiles, slots), dtype=torch.int32, device="cuda")
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x)

    def lengths(name, ref, starts, counts, n_big, nbig_rows, wrapper_rows, launch):
        for run_rows in (wrapper_rows // 2, wrapper_rows, 2 * wrapper_rows):
            depth, tid = torch.empty_like(ref[0]), torch.empty_like(ref[1])
            groups = run_rows // tr.CHUNK
            R = chip_smoke.worklist_plan(starts, counts, n_big, nbig_rows, ntiles,
                                         run_groups=groups)[0]
            ms = chip_smoke._time_ms(lambda: cuda_lib.check(launch(depth, tid, groups), name),
                                     50)
            same = bool(torch.equal(depth, ref[0])) and bool(torch.equal(tid, ref[1]))
            print(f"{name} [{run_rows} rows a run, R={R}]: ms={ms:.4f} bit_equal={same} "
                  f"walked_rows={int(counts.sum())} on {card}", flush=True)

    tri, aabb = targets["TriSetup"], targets["TriAABB"]
    order, starts, counts, big_ids, n_big, _ = rsetup.bin_sorted(
        tri.valid, aabb, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tr.TILE_W, tile_h=tr.TILE_H)
    rows, big, _ = tr.build_stream_rows(tri, aabb, order, big_ids, attrs=None, chunk=128)
    w0, nw = tr.dma_windows(starts, counts, 128)
    n_big = n_big.to(torch.int32).reshape(())
    s8, c8 = w0 * 128, nw * 128
    lengths("raster_dma", tr.rasterize_dma_cuda(rows, big, w0, nw, n_big, **kw, dchunk=128),
            s8, c8, n_big, big.shape[0], tr.DMA_RUN_ROWS,
            lambda depth, tid, groups: lib.sailor_raster_worklist(
                rows.data_ptr(), rows.shape[1], big.data_ptr(), big.shape[0], n_big.data_ptr(),
                s8.data_ptr(), c8.data_ptr(), None, None, depth.data_ptr(), tid.data_ptr(),
                tiles_y, tiles_x, tr.TILE_H, groups, slots, ws.data_ptr(), stream))

    width, height = tiles_x * tr.TILE_W, tiles_y * tr.TILE_H
    dtri, daabb = rsetup.triangle_setup(scene.geometry, scene.frame.view_projection,
                                        width=width, height=height,
                                        zplane_rounding="standalone")
    passes, _ = rsetup.bin_all(dtri.valid, daabb, tiles_x=tiles_x, tiles_y=tiles_y,
                               tile_w=tr.TILE_W, tile_h=tr.TILE_H,
                               capacity=chip_smoke.SLICE_CONFIG["bin_capacity"],
                               rounds=chip_smoke.SLICE_CONFIG["bin_rounds"])
    names = ["first"] + [f"round{i + 1}" for i in range(1, len(passes) - 1)] + ["big_pass"]
    none = torch.zeros((), dtype=torch.int32, device="cuda")
    for clamp in (True, False):
        table = tr.dense_table(dtri, daabb if clamp else None)
        for pname, (bins, pcounts) in zip(names, passes):
            ids = bins.reshape(-1).to(torch.int32).contiguous()
            pcounts = pcounts.reshape(-1).to(torch.int32).contiguous()
            s9 = chip_smoke.dense_starts(ids, ntiles)
            lengths(f"raster_dense[{pname}{'' if clamp else ',no_aabb'}]",
                    tr.rasterize_tiles_cuda(table, ids, pcounts, **kw), s9, pcounts, none,
                    0, tr.DENSE_RUN_ROWS,
                    lambda depth, tid, groups: lib.sailor_raster_dense(
                        table.data_ptr(), table.shape[1], ids.data_ptr(), s9.data_ptr(),
                        pcounts.data_ptr(), None, None, depth.data_ptr(), tid.data_ptr(),
                        tiles_y, tiles_x, tr.TILE_H, groups, slots, ws.data_ptr(), stream))


def slab_variants(libs, card, stream):
    """B4 and its variants on the bench tracer scene's bounce-1 rays."""
    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_scene

    scene, cam, view, proj = tracer_scene()
    p = chip_smoke.tracer_passes(scene, cam, view, proj, *chip_smoke.TRACER[:2])[2]
    sw = scene.sweep
    args = (p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous(), p["tmax"],
            sw.cl_min, sw.cl_max)
    ref = sweep.visit_tables_cuda(*args)
    rp, nc = p["tmax"].shape[0], sw.n_clusters
    nb = rp // sweep.RAY_BLOCK
    for name, (lib, regs) in libs.items():
        out = {k: torch.empty_like(v) for k, v in ref.items()}

        def run():
            cuda_lib.check(lib.sailor_slab_tables(
                *(t.data_ptr() for t in args), *(t.data_ptr() for t in out.values()), None, nb,
                nc, sweep.SUB, sweep.RAY_BLOCK // sweep.SUB, stream), name)

        ms = chip_smoke._time_ms(run, 50)
        print(f"slab_entry [{name}]: ms={ms:.4f} bit_equal={chip_smoke.tables_equal(out, ref)} "
              f"ptxas: {regs} on {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
