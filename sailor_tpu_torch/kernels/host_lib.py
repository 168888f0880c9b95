"""Build and load the port's host C++ library (``csrc/bvh8_build.cpp``).

The BVH8 builder is host code: it builds with the system C++ compiler
(``$CXX``, else ``g++``, else ``c++``), needs no CUDA toolkit, and so
builds on a machine without a card too. Flags are the JAX package's
native build's, ``-O3 -march=native -std=c++17 -fPIC``, so both build the
same tables bit for bit. The library goes to
``build/host/<hash>/libsailor_torch_host.so`` at the root of the checkout
(listed in ``.gitignore``); the hash takes in the source, the flags, the
compiler's version and the host CPU (its vendor, family, model, stepping
and feature flags), because a ``-march=native`` binary can fault on another
CPU. Concurrent processes (test workers) serialise the build on a lock
file and the library is written by an atomic rename. A failed build
raises: nothing falls back to another builder.
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
SOURCE = "bvh8_build.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: the host BVH8 builder needs g++ or $CXX")


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


def _digest(cxx: str) -> str:
    version = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + version.encode()
                       + _cpu_fingerprint().encode())
    with open(os.path.join(_CSRC, SOURCE), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def _build(cxx: str, out_dir: str, lib: str) -> None:
    import fcntl

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib):  # another process built it meanwhile
                return
            tmp = f"{lib}.{os.getpid()}.tmp"
            out = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", tmp,
                                  os.path.join(_CSRC, SOURCE)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{out.stdout}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load():
    """The loaded host library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _cxx()
        out_dir = os.path.join(_ROOT, "build", "host", _digest(cxx))
        path = os.path.join(out_dir, "libsailor_torch_host.so")
        if not os.path.exists(path):
            _build(cxx, out_dir, path)
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        # v0, v1, v2, num_tris, table, max_rows -> rows (or -rows needed)
        lib.sailor_torch_bvh8_build.argtypes = [fp, fp, fp, ctypes.c_int, fp, ctypes.c_int]
        lib.sailor_torch_bvh8_build.restype = ctypes.c_int
        _lib = lib
        return lib
