"""The BVH8 traversal (csrc/bvh8.cu) beside variants of itself and beside
its one-thread-a-ray form (tests/torch_bvh8_thread_per_ray.cu) on one
NVIDIA GPU, on the four passes that chip_smoke.py times: the bounce-1 rays
and their shadow rays of tracer-512-batch4 (the bench tracer scene, 4
pooled samples) and of tracer-512-dense (294,914 triangles, one sample),
at 512x512. Each variant is the kernel's source with one design choice
changed by a text edit, built with the same nvcc flags into
build/variants/ (all builds started together); each is held bit for bit
to the twin and timed with CUDA events (20 launches after a warm-up), in
turns: the variants in order, then in reverse order, on each pass. Not a
test (it is not collected): the measurement behind the design steps in
csrc/bvh8.cu's note and PERF.md.

    python tests/torch_bvh8_variants.py

Variants: the one-thread-a-ray kernel it replaced; the persistent kernel
with no refill (a warp fetches only when all 32 lanes are idle) and
refilling at 1, 8 and 24 idle lanes (16 as built); leaves taken together
(a lane at a leaf waits while its warp steps internal rows, at most 1, 2
and 4 steps, or for all of them); chunks of 2 and 4 batches a fetch;
4-byte loads; jnp.minimum/maximum by compares and selects; empty slots
skipped by a branch; L2-only loads; the stack in shared memory; 6 and 8
blocks an SM (registers capped by __launch_bounds__); the flag quad first,
then a leaf's columns one float at a time (fewer registers), also at 6
and 7 blocks an SM; 32 and 256 threads a block.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sailor_tpu_torch.kernels import cuda_lib  # noqa: E402
from sailor_tpu_torch.raytracing import bvh8  # noqa: E402

CSRC = os.path.join(ROOT, "sailor_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
THREAD_PER_RAY = os.path.join(ROOT, "tests", "torch_bvh8_thread_per_ray.cu")


def knobs(refill=None, blocks=None, threads=None):
    """Edits that set the refill threshold or the threads a block, or cap
    the registers for ``blocks`` blocks an SM."""
    edits = []
    if threads is not None:
        edits.append((r"constexpr int THREADS = \d+;", f"constexpr int THREADS = {threads};"))
    if refill is not None:
        edits.append((r"constexpr int REFILL_IDLE = \d+;", f"constexpr int REFILL_IDLE = {refill};"))
    if blocks is not None:
        edits.append((re.escape("__launch_bounds__(THREADS)\nbvh8_kernel"),
                      f"__launch_bounds__(THREADS, {blocks})\nbvh8_kernel"))
    return edits


SCALAR_LOADS = [(re.escape("__device__ __forceinline__ float4 quad(const float4* row, int q) "
                           "{ return __ldg(row + q); }"), r"""__device__ __forceinline__ float4 quad(const float4* row, int q) {
  const float* f = reinterpret_cast<const float*>(row + q);
  float4 r;
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(r.x) : "l"(f));
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(r.y) : "l"(f + 1));
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(r.z) : "l"(f + 2));
  asm("ld.global.nc.f32 %0, [%1];" : "=f"(r.w) : "l"(f + 3));
  return r;
}""")]
L2_ONLY = [(re.escape("{ return __ldg(row + q); }"), "{ return __ldcg(row + q); }")]
# the stack in shared memory, entry k of thread j at [k][j] (a lane's
# entries in one bank), in place of each thread's local memory
SHARED_STACK = [
    (re.escape("  int tri, sp, node;\n  int stack[MAX_STACK];\n};"),
     "  int tri, sp, node;\n};\n__shared__ int s_stack[MAX_STACK][THREADS];"),
    (r"s\.stack\[([^\]]*)\]", r"s_stack[\1][threadIdx.x]"),
]
# the flag quad first, then an internal row's quads 0-13, or a leaf's
# columns read one float at a time as each slot needs them (fewer values
# live at once: the register cap of more blocks an SM)
SCALAR_LEAF = [
    (re.escape("__device__ __forceinline__ void leaf_test(const Ray& ray, State& s, "
               "const float (&r)[ROW]) {"),
     "struct ScalarRow {\n  const float* f;\n"
     "  __device__ float operator[](int i) const { return __ldg(f + i); }\n};\n\n"
     "template <class Row>\n"
     "__device__ __forceinline__ void leaf_test(const Ray& ray, State& s, const Row& r) {"),
    (re.escape("template <bool LEAF>\n__device__ __forceinline__ bool step(const Ray& ray, "
               "State& s, const float (&r)[ROW],"),
     "template <bool LEAF, class Row>\n__device__ __forceinline__ bool step(const Ray& ray, "
     "State& s, const Row& r,"),
    (re.escape("  if (LEAF) {\n    leaf_test"), "  if constexpr (LEAF) {\n    leaf_test"),
    (r"      float r\[ROW\];\n      load_quads<0, INNER_QUADS>\(row, r\);\n(.*\n)*?"
     r"        live = step<false>\(ray, s, r, any_hit\);\n",
     """      const float4 head = quad(row, HEAD);
      bool live;
      if (head.w > 0.5f) {
        live = step<true>(ray, s, ScalarRow{reinterpret_cast<const float*>(row)}, any_hit);
      } else {
        float r[ROW];
        load_quads<0, INNER_QUADS>(row, r);
        live = step<false>(ray, s, r, any_hit);
"""),
]


# jnp.maximum/minimum by compares and selects (sailor::min_nan's form)
SELECT_MIN_MAX = [
    (re.escape(f'asm("{op}.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));'),
     f"d = a != a ? a : (b != b ? b : {fn}(a, b));")
    for op, fn in (("max", "fmaxf"), ("min", "fminf"))]
RCP = [(re.escape("1.0f / det"), "__frcp_rn(det)")]
# empty slots (id or child index < 0) skipped by a branch, not computed
SKIP_EMPTY = [
    (re.escape("  for (int k = 0; k < 7; ++k) {\n    const float v0x"),
     "  for (int k = 0; k < 7; ++k) {\n    t_k[k] = __int_as_float(0x7f800000);\n"
     "    u_k[k] = v_k[k] = 0.0f;\n    if (__float_as_int(r[L_ID + k]) < 0) continue;\n"
     "    const float v0x"),
    (re.escape("    const bool ok = id >= 0 && "), "    const bool ok = "),
    (re.escape("  for (int c = 0; c < 8; ++c) {\n    const float tx0"),
     "  for (int c = 0; c < 8; ++c) {\n    tn[c] = 0.0f;\n"
     "    if (__float_as_int(r[I_CHILD + c]) < 0) continue;\n    const float tx0"),
    (re.escape(" && __float_as_int(r[I_CHILD + c]) >= 0) {"), ") {"),
]


def chunks(c):
    """A warp takes c batches of 32 rays from the counter at a time."""
    return [
        (re.escape("  bool drained = false;"),
         "  int chunk = 0, chunk_end = 0;\n  bool drained = false;"),
        (re.escape("      int base = 0;\n      if (lane == 0) base = atomicAdd(next, 32);\n"
                   "      base = __shfl_sync(FULL, base, 0);\n      drained = base >= n - 32;\n"
                   "      const int i = base + lane;\n"),
         f"""      if (chunk == chunk_end) {{
        if (lane == 0) chunk = atomicAdd(next, 32 * {c});
        chunk = __shfl_sync(FULL, chunk, 0);
        chunk_end = min(chunk + 32 * {c}, n);
      }}
      const int i = chunk + lane;
      chunk += 32;
      drained = chunk >= n;
""")]


def leaf_wait(w):
    """Leaves taken together: a lane at a leaf waits while lanes of its warp
    step internal rows, at most w internal steps."""
    return [
        (re.escape("  bool drained = false;"), "  int waited = 0;\n  bool drained = false;"),
        (r"    if \(id >= 0\) \{\n      const float4\* row(.*\n)*?      if \(!live\) \{\n",
         f"""    float r[ROW];
    bool at_leaf = false;
    const float4* row = rows + static_cast<size_t>(s.node) * QUADS;
    if (id >= 0) {{
      load_quads<0, INNER_QUADS>(row, r);
      const float4 head = quad(row, HEAD);
      r[4 * HEAD] = head.x;
      r[4 * HEAD + 1] = head.y;
      at_leaf = head.w > 0.5f;
    }}
    const unsigned leaves = __ballot_sync(FULL, at_leaf);
    const bool inner_turn = busy != leaves;
    const bool leaf_turn = leaves && (!inner_turn || waited >= {w});
    waited = leaf_turn ? 0 : waited + (leaves != 0);
    bool stepped = false, live = false;
    if (inner_turn && id >= 0 && !at_leaf) {{
      live = step<false>(ray, s, r, any_hit);
      stepped = true;
    }} else if (leaf_turn && at_leaf) {{
      load_quads<INNER_QUADS, LEAF_QUADS>(row, r);
      live = step<true>(ray, s, r, any_hit);
      stepped = true;
    }}
    {{
      if (stepped && !live) {{
"""),
    ]


NEVER = 1 << 30

VARIANTS = {
    "as built": [],
    "no refill": knobs(refill=32),
    **{f"refill {r}": knobs(refill=r) for r in (1, 8, 24)},
    **{f"leaf wait {w}": leaf_wait(w) for w in (1, 2, 4)},
    "leaves wait for all": leaf_wait(NEVER),
    **{f"chunks of {c} batches": chunks(c) for c in (2, 4)},
    "4-byte loads": SCALAR_LOADS,
    "min/max by selects": SELECT_MIN_MAX,
    "empty slots skipped": SKIP_EMPTY,
    "L2-only loads": L2_ONLY,
    "stack in shared memory": SHARED_STACK,
    **{f"{k} blocks an SM": knobs(blocks=k) for k in (6, 8)},
    "flag first, 4-byte leaf loads": SCALAR_LEAF,
    **{f"flag first, 4-byte leaf loads, {k} blocks an SM": SCALAR_LEAF + knobs(blocks=k)
       for k in (6, 7)},
    **{f"{k} threads a block": knobs(threads=k) for k in (32, 256)},
}


def build(name, src, edits):
    """Start nvcc on `src` with `edits` (regex, replacement) applied."""
    text = open(src).read()
    for old, new in edits:
        if not re.search(old, text):
            raise RuntimeError(f"bvh8 [{name}]: the source no longer has {old!r}")
        text = re.sub(old, lambda m: m.expand(new), text)
    label = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    stem = os.path.join(OUT, "bvh8_" + label)
    with open(stem + ".cu", "w") as f:
        f.write(text)
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", CSRC, "-shared", stem + ".cu",
           "-o", stem + ".so"]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), stem + ".so"


def load(proc, path, label, argtypes):
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {label}:\n{out}")
    regs = "; ".join(line.split(":")[-1].strip() for line in out.splitlines()
                     if "registers" in line or "spill" in line)
    lib = ctypes.CDLL(path)
    lib.sailor_bvh8_intersect.argtypes = list(argtypes)
    lib.sailor_bvh8_intersect.restype = ctypes.c_int
    return lib, regs


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device and nvcc", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(CSRC, "bvh8.cu")
    procs = {name: build(name, src, e) for name, e in VARIANTS.items()}
    procs["one thread a ray"] = build("one thread a ray", THREAD_PER_RAY, [])
    sig = cuda_lib._SIGNATURES["sailor_bvh8_intersect"]
    libs = {name: load(*p, name, sig[:-2] + sig[-1:] if name == "one thread a ray" else sig)
            for name, p in procs.items()}
    card = chip_smoke._card()
    for name, (_, regs) in libs.items():
        print(f"bvh8 [{name}] ptxas: {regs}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    counter = torch.empty(1, dtype=torch.int32, device="cuda")
    width, height = chip_smoke.TRACER[:2]
    for label, make, sb, _ in chip_smoke.bvh8_cells():
        scene, cam, view, proj = make()
        table = scene.bvh.table
        passes = chip_smoke.record_passes(scene, cam, view, proj, width, height,
                                          sample_batch=sb)
        for pname, p in (("bounce1", passes[2]), ("bounce1_shadow", passes[3])):
            args = bvh8.ray_inputs(p["origin"], p["direction"], None, p["active"])
            any_hit = p["any_hit"]
            want = bvh8.intersect_plain(table, *args, any_hit=any_hit)
            r = args[0].shape[0]
            outs = [torch.empty(r, device="cuda"), torch.empty(r, dtype=torch.int32, device="cuda"),
                    torch.empty(r, device="cuda"), torch.empty(r, device="cuda")]
            times = {name: [] for name in libs}
            same = {}

            def run(name, lib):
                extra = () if name == "one thread a ray" else (counter.data_ptr(),)
                cuda_lib.check(lib.sailor_bvh8_intersect(
                    table.data_ptr(), *(a.data_ptr() for a in args),
                    *(o.data_ptr() for o in outs), r, int(any_hit), *extra, stream), name)

            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    lib = libs[name][0]
                    for o in outs:
                        o.fill_(7)
                    run(name, lib)
                    ok = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                             for a, b in zip(outs, want))
                    same[name] = same.get(name, True) and ok
                    times[name].append(chip_smoke._time_ms(lambda: run(name, lib), 20))
            base = sum(times["one thread a ray"]) / 2
            for name, ts in times.items():
                ms = sum(ts) / 2
                print(f"bvh8_intersect[{label}/{pname}] [{name}]: ms={ms:.4f} "
                      f"turns={[round(t, 4) for t in ts]} bit_equal={same[name]} "
                      f"speedup_over_one_thread_a_ray={base / ms:.2f} on {card}", flush=True)
        del scene
    return 0


if __name__ == "__main__":
    sys.exit(main())
