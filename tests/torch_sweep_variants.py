"""B5 (csrc/sweep.cu) as built beside two others on one NVIDIA GPU, on the
bench tracer scene's bounce-1 (closest hit) and bounce-1 shadow (any hit)
passes at 512x512 (cluster 256): B5 with every cluster size on the
any-size walk (`walk_chunks`, the launcher's choice edited), and, given a
parent checkout's csrc directory, the parent's B5. Each is built with
cuda_lib's nvcc flags into build/variants/sweep/, held to the twin bit for
bit, and timed with CUDA events over 20 launches, in turns (each variant,
then in reverse, twice). Not a test (it is not collected): the
measurement behind csrc/sweep_common.cuh's point 5.

    python tests/torch_sweep_variants.py [PARENT_CSRC]

PARENT_CSRC: e.g. build/parent/sailor_tpu_torch/csrc after
`git archive <commit> | tar -x -C build/parent`; its sailor_sweep takes no
cluster argument.
"""

import ctypes
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
from sailor_tpu_torch.scenes import tracer_scene  # noqa: E402

CSRC = os.path.join(ROOT, "sailor_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants", "sweep")
ONE_WALK = ("kernels[any_hit ? 1 : 0][cluster == CHUNK ? 0 : 1]", "kernels[any_hit ? 1 : 0][1]")


def build(name, src_dir, edits):
    """Start nvcc on src_dir/sweep.cu with `edits` applied to it; (process, dir)."""
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
           "-o", os.path.join(d, "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def main(argv):
    if not torch.cuda.is_available():
        print("needs a CUDA device and nvcc", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    procs = {"as built": build("as built", CSRC, []),
             "one walk for all sizes": build("one walk", CSRC, [ONE_WALK])}
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
        sig = list(cuda_lib._SIGNATURES["sailor_sweep"])
        if name == "parent":
            del sig[12]  # no cluster argument
        lib.sailor_sweep.argtypes = sig
        libs[name] = lib
    card = chip_smoke._card()
    scene, cam, view, proj = tracer_scene()
    passes = chip_smoke.tracer_passes(scene, cam, view, proj, 512, 512)
    sw = scene.sweep
    stream = torch.cuda.current_stream().cuda_stream
    for label, p in (("bounce1", passes[2]), ("bounce1_shadow", passes[3])):
        any_hit, rp, nc = p["any_hit"], p["feats"].shape[0], sw.n_clusters
        args = (p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"], p["tmax"],
                sw.g_cluster)
        t_p, i_p = sweep.sweep_plain(*args, any_hit=any_hit)
        t = torch.empty(rp, device="cuda")
        i = torch.empty(rp, dtype=torch.int32, device="cuda")
        ptrs = [x.data_ptr() for x in (*args, t, i)]

        def run(name):
            extra = () if name == "parent" else (sw.cluster,)
            return lambda: cuda_lib.check(libs[name].sailor_sweep(
                *ptrs, rp // sweep.SUB, sweep.RAY_BLOCK // sweep.SUB, nc, *extra, int(any_hit),
                stream), name)

        times = {name: [] for name in libs}
        for name in libs:
            run(name)()
            torch.cuda.synchronize()
            ok = torch.equal(i, i_p) and torch.equal(t.view(torch.int32), t_p.view(torch.int32))
            if not ok:
                raise RuntimeError(f"{name} disagrees with the twin on {label}")
        for name in (list(libs) + list(libs)[::-1]) * 2:
            fn = run(name)
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            times[name].append(round(start.elapsed_time(end) / 20, 4))
        print(f"sweep [{label}] ms a launch, in turns, on {card}: " + "; ".join(
            f"{name} {min(v)}-{max(v)} {v}" for name, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
