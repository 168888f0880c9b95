"""In-engine benchmark and sanity suites (counterpart of
sailor_tpu/utils/benchmarks.py; Runtime/Containers/*Benchmark.cpp and
Runtime/Memory/Memory.h RunMemoryBenchmark): console commands that time an
engine container against a trusted oracle and check that both agree.

They compare ComponentPool with a dict, the native arena with Python
allocation, the native scheduler's fan-out with the task list, the native
BVH8 build with the numpy one (then both traversed with ``bvh8.intersect``
on ``device``: the BVH8 kernel on the card), and ``m3.trs`` on ``device``
with a numpy oracle. ``device`` is the card unless the caller names
another; times are host wall-clock times of the whole suite and its parts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sailor_tpu_torch.config import resolve_device

ALL = ("memory", "pool", "scheduler", "bvh", "math")
DEVICE_SUITES = ("bvh", "math")


def run(name: str, device=None) -> str:
    fn = globals()[f"bench_{name}"]
    kw = {"device": resolve_device(device)} if name in DEVICE_SUITES else {}
    t0 = time.perf_counter()
    ok, detail = fn(**kw)
    dt = (time.perf_counter() - t0) * 1e3
    status = "PASSED" if ok else "FAILED"
    return f"{name}.benchmark {status} in {dt:.1f}ms — {detail}"


def bench_pool():
    """ComponentPool acquire/release/iterate against a plain dict oracle."""
    from sailor_tpu_torch.ecs.ecs import ComponentPool

    n = 20000
    pool = ComponentPool({"value": ((3,), np.float32, 0.0)}, capacity=64)
    oracle = {}
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = []
    for i in range(n):
        h = pool.acquire()
        v = rng.random(3).astype(np.float32)
        pool.value[h] = v
        oracle[h] = v
        handles.append(h)
        if i % 3 == 0 and handles:
            k = handles.pop(rng.integers(len(handles)))
            pool.release(k)
            oracle.pop(k)
    t_pool = time.perf_counter() - t0
    ok = pool.num_alive == len(oracle) and all(
        np.allclose(pool.value[h], oracle[h]) for h in handles)
    return ok, f"{n} ops in {t_pool * 1e3:.1f}ms, {pool.num_alive} alive"


def bench_memory():
    """Native arena throughput against Python allocation."""
    from sailor_tpu_torch import native_bridge as nb

    lib = nb.load()
    n = 100000
    a = lib.sailor_torch_arena_create(1 << 20)
    try:
        t0 = time.perf_counter()
        ptrs = [lib.sailor_torch_arena_alloc(a, 64, 16) for _ in range(n)]
        t_arena = time.perf_counter() - t0
        ok = all(p and p % 16 == 0 for p in ptrs) and len(set(ptrs)) == n
    finally:
        lib.sailor_torch_arena_destroy(a)
    t0 = time.perf_counter()
    keep = [bytearray(64) for _ in range(n)]
    t_py = time.perf_counter() - t0
    del keep
    return ok, f"arena {n / t_arena / 1e6:.2f}M allocs/s vs python {n / t_py / 1e6:.2f}M/s"


def bench_scheduler():
    """Native scheduler fan-out: every task runs once."""
    from sailor_tpu_torch import native_bridge as nb

    s = nb.Scheduler(4)
    try:
        n = 500
        results = []
        t0 = time.perf_counter()
        for k in range(n):
            s.submit(lambda k=k: results.append(k))
        s.wait_idle(timeout=60)
        dt = time.perf_counter() - t0
        ok = sorted(results) == list(range(n))
        return ok, f"{n} tasks in {dt * 1e3:.1f}ms"
    finally:
        s.shutdown()


def bench_bvh(device):
    """Native BVH8 build against the numpy builder: the same hits when both
    are traversed on ``device``."""
    from sailor_tpu_torch.assets import primitives
    from sailor_tpu_torch.raytracing import bvh8

    m = primitives.uv_sphere(1.0, 10, 16)
    v, i = m.positions, m.indices
    v0, v1, v2 = v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]
    t0 = time.perf_counter()
    bn = bvh8.build(v0, v1, v2, use_native=True, device=device)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    bp = bvh8.build(v0, v1, v2, use_native=False, device=device)
    t_python = time.perf_counter() - t0
    o = torch.tensor([[0.0, 0.0, 3.0], [2.0, 2.0, 3.0]], device=device)
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], device=device)
    rn = bvh8.intersect(bn, o, d)
    rp = bvh8.intersect(bp, o, d)
    ok = bool(torch.equal(rn["hit"], rp["hit"]))
    return ok, f"native {t_native * 1e3:.1f}ms vs python {t_python * 1e3:.0f}ms"


def bench_math(device):
    """``m3.trs`` on ``device`` against a numpy oracle (a basis vector
    rotated by the quaternion, scaled, translated)."""
    from sailor_tpu_torch.core import math3d as m3

    rng = np.random.default_rng(1)
    t = rng.normal(size=(256, 3)).astype(np.float32)
    q = rng.normal(size=(256, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.5, 2.0, (256, 3)).astype(np.float32)
    t0 = time.perf_counter()
    m = m3.trs(*(torch.from_numpy(x).to(device) for x in (t, q, s))).cpu().numpy()
    dt = time.perf_counter() - t0
    qv, w = q[:, :3].astype(np.float64), q[:, 3:].astype(np.float64)
    x = s * np.asarray([1.0, 0, 0])
    c = 2.0 * np.cross(qv, x)
    p = x + w * c + np.cross(qv, c) + t
    p2 = np.einsum("nij,j->ni", m[:, :3, :3], np.asarray([1.0, 0, 0])) + m[:, :3, 3]
    ok = np.allclose(p, p2, atol=1e-4)
    return ok, f"256 trs in {dt * 1e3:.1f}ms"
