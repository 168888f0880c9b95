"""ctypes bridge to the port's native host runtime (counterpart of
sailor_tpu/native_bridge.py; ``csrc/host_runtime.cpp``).

- ``Scheduler``: the reference's thread-class task system
  (Runtime/Tasks/Scheduler.h): dependency lists, continuations, waits;
- ``Pool`` and ``MultiPool``: fixed-block and size-class allocators
  (TPoolAllocator / TMultiPoolAllocator) with occupancy stats; the arena
  (a page-chained bump allocator) is used through the library's
  ``sailor_torch_arena_*`` entries;
- ``bvh_build`` and ``bvh8_build``: the binned-SAH binary BVH of
  ``csrc/bvh8_build.cpp`` and the packed 8-wide table collapsed from it,
  the table ``raytracing/bvh8.py`` traverses.

``kernels/host_lib.py`` builds both libraries at first use. Unlike the
reference, nothing falls back to Python: a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from sailor_tpu_torch.kernels import host_lib


def load():
    """The runtime library, built on first use; a failed build raises."""
    return host_lib.load("runtime")


def available() -> bool:
    """True once the runtime library is loaded; a failed build raises
    (there is no Python runtime to report instead)."""
    return load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bvh_build(v0, v1, v2, leaf_size: int = 4):
    """Native binned-SAH build: a dict of flat arrays in raytracing/bvh.py's
    layout (node_min, node_max, node_left, node_start, node_count, order)."""
    lib = host_lib.load("bvh8")
    v0, v1, v2 = (np.ascontiguousarray(x, np.float32) for x in (v0, v1, v2))
    t = len(v0)
    cap = 2 * max(t, 1)
    nmin = np.zeros((cap, 3), np.float32)
    nmax = np.zeros((cap, 3), np.float32)
    nleft = np.zeros(cap, np.int32)
    nstart = np.zeros(cap, np.int32)
    ncount = np.zeros(cap, np.int32)
    order = np.zeros(max(t, 1), np.int32)
    n = lib.sailor_torch_bvh_build(_f32p(v0), _f32p(v1), _f32p(v2), t, leaf_size,
                                   _f32p(nmin), _f32p(nmax), _i32p(nleft), _i32p(nstart),
                                   _i32p(ncount), _i32p(order))
    return {"node_min": nmin[:n], "node_max": nmax[:n], "node_left": nleft[:n],
            "node_start": nstart[:n], "node_count": ncount[:n], "order": order[:t]}


def bvh8_build(v0, v1, v2) -> np.ndarray:
    """Native packed 8-wide table build: (rows, bvh8.ROW) float32 in
    raytracing/bvh8.py's layout."""
    lib = host_lib.load("bvh8")
    v0, v1, v2 = (np.ascontiguousarray(x, np.float32) for x in (v0, v1, v2))
    t = len(v0)
    max_rows = 2 * max(t, 2)
    while True:
        table = np.zeros((max_rows, 72), np.float32)
        n = lib.sailor_torch_bvh8_build(_f32p(v0), _f32p(v1), _f32p(v2), t, _f32p(table),
                                        max_rows)
        if n >= 0:
            return table[:n]
        max_rows = -n  # the rows it needs


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

_TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

# Thread classes (Scheduler.h EThreadType). The library runs WORKER tasks on
# its worker threads and RENDER and RHI tasks on one thread each; no thread
# serves MAIN, as in the reference, so a MAIN task stays pending.
RENDER, WORKER, MAIN, RHI = 0, 1, 2, 3


def _ms(timeout: float) -> int:
    return max(0, int(timeout * 1000))


class Scheduler:
    """Native thread-pool scheduler with dependency lists.

    Python callables run on the library's threads (ctypes takes the
    interpreter lock for each, so pure-Python bodies run one at a time; I/O,
    numpy and native calls release it, as the engine's asset decodes and
    BVH builds do). A task's callback stays referenced until it has run.
    Every wait takes an optional ``timeout`` in seconds and raises
    TimeoutError when it passes."""

    def __init__(self, num_workers: int = 0):
        self._lib = load()
        self._handle = self._lib.sailor_torch_scheduler_create(num_workers)
        self._keepalive: dict[int, object] = {}
        self._results: dict[int, dict] = {}
        self._lock = threading.Lock()

    def submit(self, fn, deps=(), thread_class: int = WORKER) -> int:
        slot: dict = {}

        @_TASK_FN
        def trampoline(_arg):
            try:
                slot["value"] = fn()
            except Exception as e:  # raised again by wait()
                slot["error"] = e

        deps_arr = (ctypes.c_uint64 * max(len(deps), 1))(*deps)
        tid = self._lib.sailor_torch_scheduler_submit(
            self._handle, ctypes.cast(trampoline, ctypes.c_void_p), None, deps_arr,
            len(deps), thread_class)
        with self._lock:
            self._keepalive[tid] = trampoline
            self._results[tid] = slot
        return tid

    def then(self, dep: int, fn, thread_class: int = WORKER) -> int:
        """A continuation of ``dep`` (Tasks.h Then())."""
        return self.submit(fn, deps=(dep,), thread_class=thread_class)

    def is_done(self, tid: int) -> bool:
        return bool(self._lib.sailor_torch_scheduler_is_done(self._handle, tid))

    def wait(self, tid: int, timeout: float | None = None):
        """The task's result; its exception is raised here."""
        if timeout is None:
            self._lib.sailor_torch_scheduler_wait(self._handle, tid)
        elif not self._lib.sailor_torch_scheduler_wait_for(self._handle, tid, _ms(timeout)):
            raise TimeoutError(f"task {tid} did not finish in {timeout} s")
        with self._lock:
            slot = self._results.pop(tid, {})
            self._keepalive.pop(tid, None)
        if "error" in slot:
            raise slot["error"]
        return slot.get("value")

    def wait_idle(self, timeout: float | None = None) -> None:
        """Until no task is queued or running; then drops the callbacks of
        the finished tasks (their results stay for ``wait``)."""
        if timeout is None:
            self._lib.sailor_torch_scheduler_wait_idle(self._handle)
        elif not self._lib.sailor_torch_scheduler_wait_idle_for(self._handle, _ms(timeout)):
            raise TimeoutError(f"the scheduler was not idle after {timeout} s")
        with self._lock:
            for tid in [t for t in self._keepalive if self.is_done(t)]:
                del self._keepalive[tid]

    @property
    def num_pending(self) -> int:
        return self._lib.sailor_torch_scheduler_num_pending(self._handle)

    def shutdown(self) -> None:
        """Stops the threads after their running tasks; queued tasks are
        dropped."""
        if getattr(self, "_handle", None):  # None too when __init__ raised
            self._lib.sailor_torch_scheduler_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.shutdown()


# ---------------------------------------------------------------------------
# Pool / multi-pool allocators
# ---------------------------------------------------------------------------


def _stats(fn, handle) -> dict:
    out = (ctypes.c_size_t * 4)()
    fn(handle, out)
    return {"pages": out[0], "capacity": out[1], "used": out[2], "reserved_bytes": out[3]}


class Pool:
    """Fixed-block native pool with occupancy stats (TPoolAllocator)."""

    def __init__(self, block_size: int = 64, blocks_per_page: int = 256):
        self._lib = load()
        self._h = self._lib.sailor_torch_pool_create(block_size, blocks_per_page)

    def alloc(self) -> int:
        return self._lib.sailor_torch_pool_alloc(self._h)

    def free(self, ptr: int) -> None:
        self._lib.sailor_torch_pool_free(self._h, ptr)

    def stats(self) -> dict:
        return _stats(self._lib.sailor_torch_pool_stats, self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.sailor_torch_pool_destroy(self._h)
            self._h = None


class MultiPool:
    """Size-class router over pools (TMultiPoolAllocator): 16 B..64 KiB
    power-of-two classes; larger blocks come from the system heap."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.sailor_torch_mpool_create()

    def alloc(self, size: int) -> int:
        return self._lib.sailor_torch_mpool_alloc(self._h, size)

    def free(self, ptr: int, size: int) -> None:
        self._lib.sailor_torch_mpool_free(self._h, ptr, size)

    def stats(self) -> dict:
        return _stats(self._lib.sailor_torch_mpool_stats, self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.sailor_torch_mpool_destroy(self._h)
            self._h = None
