"""Build and load the port's hand-written CUDA kernels.

The sources under ``sailor_tpu_torch/csrc/`` have a plain C interface. At
first use they are compiled for Hopper (``sm_90a``) with ``nvcc``, one
process per source, all started together, then linked into one shared
library ``libsailor_torch_kernels.so`` that ``ctypes`` loads. The build
directory ``build/kernels/<hash of the sources and flags>/`` sits at the
root of the checkout (listed in ``.gitignore``), so a fresh checkout builds
once and an edited source builds anew.

Every pointer and the stream go through ``ctypes.c_void_p``; every C entry
point returns ``cudaGetLastError()`` and :func:`check` raises if it is not 0.
``LAUNCHES`` counts successful launches per kernel; each wrapper adds one
(``count``) where it launches its kernel and nowhere else. Each launch runs
with its tensors' device current (``launch``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCES = ("bvh8.cu", "raster.cu", "resolve.cu", "resolve_stream.cu", "shade.cu",
            "slab_entry.cu", "sweep.cu", "sweep_grid.cu")
# -fmad=false: the rounding rule of csrc/common.cuh
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
build_seconds = None
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # table, origin, direction, t0, active, t, tri, u, v, n_rays, any_hit,
    # ray counter (scratch), stream
    "sailor_bvh8_intersect": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    # info (6 int32: registers, shared bytes, local bytes, resident blocks,
    # threads a block, refill threshold)
    "sailor_bvh8_info": (_P,),
    # rows, ncols, big_rows, nbig_rows, n_big*, starts, counts, zlo, zhi,
    # depth, tid, tiles_y, tiles_x, tile_h, run_groups, slots, workspace,
    # stream
    "sailor_raster_worklist": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P, _P),
    # rows, ncols, big_rows, nbig_rows, n_big*, c0, spt, zlo, zhi, depth,
    # tid, tiles_y, tiles_x, tile_h, chunk, mxu, run_groups, slots,
    # workspace, stream
    "sailor_raster_stream": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # table, width, ids, starts, counts, zlo, zhi, depth, tid, tiles_y,
    # tiles_x, tile_h, run_groups, slots, workspace, stream
    "sailor_raster_dense": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P, _P),
    # rows, ncols, big_rows, nbig_rows, tid, starts, counts, c0, spt, par,
    # out, n_out, tiles_y, tiles_x, tile_h, chunk, stream
    "sailor_resolve_stream": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P),
    # rows, ncols, big_rows, nbig_rows, tid, starts, counts, par, out,
    # n_out, mode, tiles_y, tiles_x, tile_h, stream
    "sailor_resolve_worklist": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _P),
    # table, n_lights, indices, counts, albedo, metallic, roughness, normal,
    # wpos, shadow, cam, out, K, height, width, stream
    "sailor_shade_forward_plus": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _I, _I, _I, _P),
    # origin, direction, tmax, cl_min, cl_max, feats, e_bits, order,
    # blk_bits, nlive, scratch (0 while sweep.slab_smem_clusters() holds the
    # clusters), n_blocks, n_clusters, sub-block size, sub-blocks per block,
    # stream
    "sailor_slab_tables": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, best_t, best_i,
    # n_sub_blocks, sub-blocks per block, sub-block size, n_clusters,
    # cluster, any_hit, stream
    "sailor_sweep": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # e_bits, order, feats, tmax, g_cluster, best_t, best_i, n_sub_blocks,
    # sub-blocks per block, sub-block size, n_clusters, cluster, any_hit,
    # stream
    "sailor_sweep_grid": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _build(out_dir: str) -> str:
    """Compile each source to an object in parallel, link one library."""
    global build_log
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in _SOURCES:
        obj = os.path.join(out_dir, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-c", os.path.join(_CSRC, src),
               "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    lib = os.path.join(out_dir, "libsailor_torch_kernels.so")
    tmp = lib + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", tmp,
         *[o for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def load():
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        import time

        t0 = time.perf_counter()
        out_dir = os.path.join(_ROOT, "build", "kernels", _digest())
        path = os.path.join(out_dir, "libsailor_torch_kernels.so")
        if not os.path.exists(path):
            path = _build(out_dir)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch(t, entry, *args):
    """``entry(*args)`` with ``t``'s device made current for the call, so a
    kernel launches on the device that holds its tensors whichever device
    the calling thread has current (a shard's thread on a second card)."""
    import torch

    with torch.cuda.device(t.device):
        return entry(*args)


def count(name: str) -> None:
    """Add one launch of ``name`` to ``LAUNCHES``; the shards of a mesh
    launch from several threads at once."""
    with _count_lock:
        LAUNCHES[name] += 1


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def dispatch(t, plain, kernel):
    """The function to run on ``t``'s device: the plain PyTorch version for
    a CPU tensor, the kernel's wrapper for a CUDA tensor. Any other device
    raises; nothing falls back."""
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no kernel for device {t.device}")


def require(t, name: str, dtype, shape=None, device=None):
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
