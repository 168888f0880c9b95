"""B1 and B3 beside variants of themselves on one NVIDIA GPU, on the
flagship frame's own inputs (1920x1088, 1000 point lights, 96 objects).
Each variant is the kernel's source under csrc/ with one design choice
undone by a text edit, built with the same nvcc flags into
build/variants/; each is timed with CUDA events (50 launches after a
warm-up) and held bit for bit to the kernel as built. Not a test (it is not
collected): a measurement behind the design notes in csrc/raster.cu and
csrc/shade.cu.

    python tests/torch_kernel_variants.py

B1 variants: R (groups a run) 2 and 8 beside 4; every group's
(rectangle, row) pairs balanced over the warps, or never (each warp its own
rows); three blocks an SM in place of four. B3 variants: torch.clamp's max
as three instructions (sailor::clamp_lo) in place of one; rsqrtf with its
subnormal rescaling; five blocks an SM; __frcp_rn's range check on each of
a pair's three reciprocals in place of one check for all three.
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

RASTER_LB = ("__global__ void __launch_bounds__(THREADS, 4)\nraster_worklist_kernel",
             "__global__ void __launch_bounds__(THREADS, 3)\nraster_worklist_kernel")
BALANCE = "  if (most * WARPS <= 2 * total + 4 * WARPS) {"
RASTER = {
    "as built": [],
    "always balanced": [(BALANCE, "  if (false) {")],
    "never balanced": [(BALANCE, "  if (true) {")],
    "3 blocks an SM": [RASTER_LB],
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
    stem = os.path.join(OUT, kernel.replace(".cu", "") + "_" + name.replace(" ", "_"))
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
                    depth.data_ptr(), tid.data_ptr(), tiles_y, tiles_x, groups, slots,
                    ws.data_ptr(), stream), name)

            ms = chip_smoke._time_ms(run, 50)
            same = bool(torch.equal(depth, d_ref)) and bool(torch.equal(tid, t_ref))
            print(f"raster_worklist [{name}, R={groups}]: ms={ms:.4f} bit_equal={same} "
                  f"ptxas: {regs} on {card}", flush=True)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
