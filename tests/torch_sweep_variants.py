"""B4 (csrc/slab_entry.cu) and B5 (csrc/sweep.cu) as built beside variants
on one NVIDIA GPU, on the bench tracer scene's bounce-1 (closest hit) and
bounce-1 shadow (any hit) passes at 512x512, at the default ray block 2048
and sub-block 256. B5 at cluster 256 as built (`walk`), on the walk for any
cluster size (`walk_chunks`) and on the walk for any sub-block size
(`walk_general`), the launcher's choice edited, and, given a parent
checkout's csrc directory, the parent's B4 and B5; then B5 over the same
triangles built at clusters 128 and 512, as built (`walk_chunks`) against
`walk_general`. Each is built with cuda_lib's nvcc flags into
build/variants/sweep/, held to the twin bit for bit, and timed with CUDA
events over 20 launches, in turns (each variant, then in reverse, twice).
Not a test (it is not collected): the measurement behind
csrc/sweep_common.cuh's points 5 and 6.

    python tests/torch_sweep_variants.py [PARENT_CSRC]

PARENT_CSRC: e.g. build/parent/sailor_tpu_torch/csrc after
`git archive <commit> | tar -x -C build/parent`; its sailor_sweep,
sailor_sweep_grid and sailor_slab_tables take no sub-block size (and its
sailor_slab_tables no sub-block count).
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sailor_tpu_torch.kernels import cuda_lib  # noqa: E402
from sailor_tpu_torch.raytracing import sweep  # noqa: E402
from sailor_tpu_torch.scenes import tracer_scene, tracer_soup  # noqa: E402

CSRC = os.path.join(ROOT, "sailor_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants", "sweep")
MODE = "const int mode = sub != SUB ? GENERAL : (cluster == CHUNK ? WALK : CHUNKS);"


def build(name, src_dir, edits):
    """Start nvcc on src_dir's sweep.cu and slab_entry.cu, with `edits`
    applied to sweep.cu; (process, dir)."""
    d = os.path.join(OUT, name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    path = os.path.join(d, "sweep.cu")
    src = open(path).read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"sweep.cu [{name}]: the source no longer has {old!r}")
        src = src.replace(old, new)
    open(path, "w").write(src)
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", d, "-shared", path,
           os.path.join(d, "slab_entry.cu"), "-o", os.path.join(d, "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def in_turns(fns, label, card):
    """Time each of ``fns`` (name: a launch) with CUDA events over 20
    launches, in turns, and print the spread of each."""
    times = {name: [] for name in fns}
    for name in (list(fns) + list(fns)[::-1]) * 2:
        fn = fns[name]
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        end.synchronize()
        times[name].append(round(start.elapsed_time(end) / 20, 4))
    print(f"{label} ms a launch, in turns, on {card}: " + "; ".join(
        f"{name} {min(v)}-{max(v)} {v}" for name, v in times.items()), flush=True)


def time_pass(libs, names, sw, p, label, card, b4):
    """Hold B5 (each of ``names``) and, with ``b4``, B4 (as built and the
    parent's) to their twins on the pass ``p`` of the sweep ``sw``, then
    time them in turns."""
    stream = torch.cuda.current_stream().cuda_stream
    nsub = sweep.RAY_BLOCK // sweep.SUB
    any_hit, rp, nc = p["any_hit"], p["feats"].shape[0], sw.n_clusters
    args = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"],
            sw.g_cluster)
    t_p, i_p = sweep.sweep_plain(*args, any_hit=any_hit)
    t = torch.empty(rp, device="cuda")
    i = torch.empty(rp, dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in (*args, t, i)]

    def run(name):
        sizes = (nsub,) if name == "parent" else (nsub, sweep.SUB)
        return lambda: cuda_lib.check(libs[name].sailor_sweep(
            *ptrs, rp // sweep.SUB, *sizes, nc, sw.cluster, int(any_hit), stream), name)

    for name in names:
        run(name)()
        torch.cuda.synchronize()
        ok = torch.equal(i, i_p) and torch.equal(t.view(torch.int32), t_p.view(torch.int32))
        if not ok:
            raise RuntimeError(f"{name} disagrees with the twin on {label}")
    in_turns({name: run(name) for name in names}, f"sweep [{label}]", card)

    if not b4:
        return
    # B4: the parent's and this build's (the walk variants share it)
    o, d = p["feats"][:, 8:11].contiguous(), p["feats"][:, 0:3].contiguous()
    ref = sweep.visit_tables_plain(o, d, p["tmax"], sw.cl_min, sw.cl_max)
    out = {k: torch.empty_like(v) for k, v in ref.items()}
    ptrs4 = [x.data_ptr() for x in (o, d, p["tmax"], sw.cl_min, sw.cl_max, *out.values())]

    def run4(name):
        sizes = () if name == "parent" else (sweep.SUB, nsub)
        return lambda: cuda_lib.check(libs[name].sailor_slab_tables(
            *ptrs4, None, rp // sweep.RAY_BLOCK, nc, *sizes, stream), name)

    b4_names = [name for name in ("as built", "parent") if name in libs]
    for name in b4_names:
        run4(name)()
        torch.cuda.synchronize()
        if not chip_smoke.tables_equal(out, ref):
            raise RuntimeError(f"{name}'s B4 disagrees with the twin on {label}")
    in_turns({name: run4(name) for name in b4_names}, f"slab_entry [{label}]", card)


def main(argv):
    if not torch.cuda.is_available():
        print("needs a CUDA device and nvcc", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    procs = {"as built": build("as built", CSRC, []),
             "any-cluster walk": build("chunks walk", CSRC, [(MODE, "const int mode = CHUNKS;")]),
             "any-sub-block walk": build("general walk", CSRC,
                                         [(MODE, "const int mode = GENERAL;")])}
    if argv:
        procs["parent"] = build("parent", argv[0], [])
    cuda_lib.load()
    libs = {}
    for name, (proc, d) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        print(f"[{name}] ptxas: " + "; ".join(
            line.split(":", 1)[1].strip() for line in out.splitlines() if "registers" in line))
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        sig5 = list(cuda_lib._SIGNATURES["sailor_sweep"])
        sig4 = list(cuda_lib._SIGNATURES["sailor_slab_tables"])
        if name == "parent":
            del sig5[11]  # no sub-block size
            del sig4[13:15]  # no sub-block size and count
        lib.sailor_sweep.argtypes = sig5
        lib.sailor_slab_tables.argtypes = sig4
        libs[name] = lib
    card = chip_smoke._card()
    scene, cam, view, proj = tracer_scene()
    soup = tracer_soup()
    tris = tuple(soup["position"][soup["indices"][:, k]] for k in range(3))
    for cluster in (256, 128, 512):
        sw = scene.sweep if cluster == scene.sweep.cluster else sweep.build(
            *tris, cluster=cluster, device="cuda")
        passes = chip_smoke.tracer_passes(dataclasses.replace(scene, sweep=sw), cam, view, proj,
                                          512, 512)
        # at 256 every walk and the parent; elsewhere the any-cluster walk (as
        # built) against the any-sub-block walk
        names = list(libs) if cluster == 256 else ["as built", "any-sub-block walk"]
        for label, p in (("bounce1", passes[2]), ("bounce1_shadow", passes[3])):
            time_pass(libs, names, sw, p, f"{label}, cluster {cluster}", card, cluster == 256)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
