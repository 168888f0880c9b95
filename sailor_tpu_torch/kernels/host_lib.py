"""Build and load the port's host C++ libraries (``csrc/*.cpp``).

Three libraries, each from one source (``LIBRARIES``):

- ``"bvh8"``: ``csrc/bvh8_build.cpp``, the binary BVH and BVH8 table
  builders, built with the JAX package's native flags, ``-O3 -march=native
  -std=c++17 -fPIC``, so both build the same tables bit for bit;
- ``"runtime"``: ``csrc/host_runtime.cpp``, the arena, pool and multi-pool
  allocators and the task scheduler (``native_bridge.py``), the same flags
  and ``-pthread``;
- ``"image"``: ``csrc/image_decode.cpp``, the serial parts of the texture
  decoders (``utils/jpeg.py``: a JPEG scan's Huffman, arithmetic or
  lossless decoding, the progressive block smoothing and the IDCT,
  upsampling and colour pass; ``utils/gif.py``: LZW), the same flags.

They are host code: each builds with the system C++ compiler (``$CXX``,
else ``g++``, else ``c++``), needs no CUDA toolkit, and so builds on a
machine without a card too. A library goes to
``build/host/<hash>/<file>`` at the root of the checkout (listed in
``.gitignore``); the hash takes in that library's own source and flags,
the compiler's version and the host CPU (its vendor, family, model,
stepping and feature flags), because a ``-march=native`` binary can fault
on another CPU, so each library rebuilds when its own source changes.
Concurrent processes (test workers) serialise a build on a lock file and
the library is written by an atomic rename. A failed build raises:
nothing falls back to another builder or to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC")
_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int32)
_szp = ctypes.POINTER(ctypes.c_size_t)
_i16p, _u8p = ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8)
_vp, _u64, _i64, _sz = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_size_t
# name -> (source, flags, library file, {entry: (restype, argtypes)})
LIBRARIES = {
    "bvh8": ("bvh8_build.cpp", CXX_FLAGS, "libsailor_torch_host.so", {
        # v0, v1, v2, num_tris, leaf_size, node_min, node_max, node_left,
        # node_start, node_count, order -> nodes
        "sailor_torch_bvh_build": (ctypes.c_int, [_fp, _fp, _fp, ctypes.c_int, ctypes.c_int,
                                                  _fp, _fp, _ip, _ip, _ip, _ip]),
        # v0, v1, v2, num_tris, table, max_rows -> rows (or -rows needed)
        "sailor_torch_bvh8_build": (ctypes.c_int, [_fp, _fp, _fp, ctypes.c_int, _fp,
                                                   ctypes.c_int]),
    }),
    "runtime": ("host_runtime.cpp", CXX_FLAGS + ("-pthread",), "libsailor_torch_runtime.so", {
        "sailor_torch_arena_create": (_vp, [_sz]),
        "sailor_torch_arena_alloc": (_vp, [_vp, _sz, _sz]),
        "sailor_torch_arena_reset": (None, [_vp]),
        "sailor_torch_arena_destroy": (None, [_vp]),
        "sailor_torch_pool_create": (_vp, [_sz, _sz]),
        "sailor_torch_pool_alloc": (_vp, [_vp]),
        "sailor_torch_pool_free": (None, [_vp, _vp]),
        "sailor_torch_pool_stats": (None, [_vp, _szp]),
        "sailor_torch_pool_destroy": (None, [_vp]),
        "sailor_torch_mpool_create": (_vp, []),
        "sailor_torch_mpool_alloc": (_vp, [_vp, _sz]),
        "sailor_torch_mpool_free": (None, [_vp, _vp, _sz]),
        "sailor_torch_mpool_stats": (None, [_vp, _szp]),
        "sailor_torch_mpool_destroy": (None, [_vp]),
        "sailor_torch_scheduler_create": (_vp, [ctypes.c_int]),
        "sailor_torch_scheduler_destroy": (None, [_vp]),
        # scheduler, fn, arg, deps, ndeps, thread_class -> task id
        "sailor_torch_scheduler_submit": (_u64, [_vp, _vp, _vp, ctypes.POINTER(_u64),
                                                 ctypes.c_int, ctypes.c_int]),
        "sailor_torch_scheduler_wait": (None, [_vp, _u64]),
        "sailor_torch_scheduler_wait_for": (ctypes.c_int, [_vp, _u64, _i64]),
        "sailor_torch_scheduler_wait_idle": (None, [_vp]),
        "sailor_torch_scheduler_wait_idle_for": (ctypes.c_int, [_vp, _i64]),
        "sailor_torch_scheduler_is_done": (ctypes.c_int, [_vp, _u64]),
        "sailor_torch_scheduler_num_pending": (ctypes.c_int, [_vp]),
    }),
    "image": ("image_decode.cpp", CXX_FLAGS, "libsailor_torch_image.so", {
        # data, size, pos, params, tables, coefs -> index of the marker after the scan
        "sailor_torch_jpeg_scan": (_i64, [ctypes.c_char_p, _i64, _i64, _ip, _ip, _i16p]),
        # data, size, pos, params, conditioning, coefs -> the same
        "sailor_torch_jpeg_scan_arith": (_i64, [ctypes.c_char_p, _i64, _i64, _ip, _ip, _i16p]),
        # data, size, pos, params, tables, samples, nsamples -> the same
        "sailor_torch_jpeg_scan_lossless": (_i64, [ctypes.c_char_p, _i64, _i64, _ip, _ip, _u8p,
                                                   _i64]),
        # coefs, quant, params, kernels, out -> 0
        "sailor_torch_jpeg_smooth": (ctypes.c_int, [_i16p, _ip, _ip, _ip, _i16p]),
        # coefs or samples, quant, params, out -> 0
        "sailor_torch_jpeg_pixels": (ctypes.c_int, [_vp, _ip, _ip, _u8p]),
        # data, size, min code size, out, pixels -> pixels written
        "sailor_torch_gif_lzw": (_i64, [ctypes.c_char_p, _i64, ctypes.c_int, _u8p, _i64]),
    }),
}

_lock = threading.Lock()
_libs: dict = {}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: the host libraries need g++ or $CXX")


def _cpu_fingerprint() -> str:
    """Digest of the host CPU's identity lines and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            parts = []
            for line in f:
                if line.startswith(("flags", "model name", "vendor_id", "cpu family",
                                    "model\t", "stepping")):
                    parts.append(line)
                    if line.startswith("flags"):
                        break
        if parts:
            return hashlib.sha256("".join(parts).encode()).hexdigest()[:16]
    except OSError:
        pass
    return hashlib.sha256(platform.machine().encode()).hexdigest()[:16]


def _digest(cxx: str, source: str, flags: tuple) -> str:
    version = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True).stdout
    h = hashlib.sha256(" ".join(flags).encode() + version.encode()
                       + _cpu_fingerprint().encode())
    with open(os.path.join(_CSRC, source), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _build(cxx: str, source: str, flags: tuple, out_dir: str, lib: str) -> None:
    import fcntl

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):  # another process built it meanwhile
                return
            tmp = f"{lib}.{os.getpid()}.tmp"
            out = subprocess.run([cxx, *flags, "-shared", "-o", tmp,
                                  os.path.join(_CSRC, source)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {source}:\n{out.stdout}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load(name: str = "bvh8"):
    """The loaded host library ``name`` (a key of LIBRARIES), built on
    first use, with its entries' signatures declared."""
    with _lock:
        if name in _libs:
            return _libs[name]
        source, flags, filename, signatures = LIBRARIES[name]
        cxx = _cxx()
        out_dir = os.path.join(_ROOT, "build", "host", _digest(cxx, source, flags))
        path = os.path.join(out_dir, filename)
        if not os.path.exists(path):
            _build(cxx, source, flags, out_dir, path)
        lib = ctypes.CDLL(path)
        for entry, (restype, argtypes) in signatures.items():
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[name] = lib
        return lib
