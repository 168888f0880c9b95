"""The port's host runtime (csrc/host_runtime.cpp through native_bridge.py),
load_async, the benchmark suites, the console's benchmark commands and
stats.memory, and the profiler, against the JAX package's on the CPU.

- The scheduler: tests/test_native.py's cases (dependency order, results,
  an exception raised again by ``wait``, a 64-task fan-out and
  ``num_pending``) with every wait bounded, continuations, a MAIN-class
  task that no thread serves (it stays pending, and shutdown still ends),
  and a stress test: 8 submitting threads, 32 workers, a 10 us switch
  interval, every result found under its own task id.
- The allocators: the arena (distinct 16-byte aligned blocks, a new page,
  the bump pointer reset) and one script of pool and multipool allocations
  and frees on both libraries: their stats equal after every step.
- ``bvh_build`` (the binary build under the BVH8 table): flat arrays equal
  to the reference's ``native_bridge.bvh_build`` and the structure of
  tests/test_native.py::test_native_bvh_structure.
- ``load_async``: a .world, a .mat and a PNG loaded asynchronously equal
  their synchronous loads, a loader's exception comes back from ``wait``,
  and a process whose load scheduler is alive exits with code 0.
- The five benchmark suites pass on the CPU, each line in the reference's
  format, and through the port's Console (tests/test_engine_aux.py's
  console and suite tests), with the multipool line in stats.memory.
- The profiler: the same scopes give the same zones and counts in both
  packages; ``device_trace`` writes a Chrome trace on the CPU.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from chip_smoke import assets_equal
from sailor_tpu import native_bridge as jax_nb
from sailor_tpu.assets import primitives as jax_primitives
from sailor_tpu.utils import profiler as jax_profiler
from sailor_tpu_torch import native_bridge as nb
from sailor_tpu_torch.assets import registry as registry_mod
from sailor_tpu_torch.assets.registry import AssetRegistry, load_async
from sailor_tpu_torch.engine import World
from sailor_tpu_torch.engine.console import Console
from sailor_tpu_torch.utils import benchmarks, profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 30.0  # seconds: every wait in this file is bounded


@pytest.fixture
def sched():
    s = nb.Scheduler(4)
    try:
        yield s
    finally:
        s.shutdown()


def test_scheduler_dependencies_and_results(sched):
    log = []
    a = sched.submit(lambda: log.append("a") or "A")
    b = sched.submit(lambda: log.append("b") or "B", deps=(a,))
    c = sched.submit(lambda: log.append("c") or "C", deps=(a, b))
    d = sched.then(c, lambda: log.append("d") or "D")
    assert sched.wait(d, WAIT) == "D" and sched.wait(c, WAIT) == "C"
    assert log == ["a", "b", "c", "d"]
    assert sched.is_done(a) and sched.is_done(b)


def test_scheduler_exception_propagates(sched):
    def boom():
        raise ValueError("task failed")

    t = sched.submit(boom)
    with pytest.raises(ValueError, match="task failed"):
        sched.wait(t, WAIT)
    after = sched.then(t, lambda: "ran")  # a failed task still completes
    assert sched.wait(after, WAIT) == "ran"


def test_scheduler_wait_idle_fanout(sched):
    results = []
    for k in range(64):
        sched.submit(lambda k=k: results.append(k))
    sched.wait_idle(WAIT)
    assert sorted(results) == list(range(64))
    assert sched.num_pending == 0


def test_scheduler_main_class_stays_pending():
    """No thread serves MAIN (as in the reference): the task stays queued,
    a bounded wait raises TimeoutError and shutdown still returns."""
    s = nb.Scheduler(2)
    try:
        t = s.submit(lambda: 1, thread_class=nb.MAIN)
        r = s.submit(lambda: 2, thread_class=nb.RENDER)
        assert s.wait(r, WAIT) == 2
        with pytest.raises(TimeoutError):
            s.wait(t, 0.2)
        assert s.num_pending == 1 and not s.is_done(t)
    finally:
        s.shutdown()


def test_scheduler_stress_many_submitters():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    s = nb.Scheduler(32)
    try:
        tids = [[] for _ in range(8)]

        def submitter(j):
            for k in range(200):
                tids[j].append((s.submit(lambda j=j, k=k: (j, k)), (j, k)))

        threads = [threading.Thread(target=submitter, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        pairs = [p for ts in tids for p in ts]
        assert len({tid for tid, _ in pairs}) == 1600
        for tid, want in pairs:
            assert s.wait(tid, WAIT) == want
    finally:
        sys.setswitchinterval(switch)
        s.shutdown()


# --- the allocators -----------------------------------------------------------


def test_arena():
    lib = nb.load()
    a = lib.sailor_torch_arena_create(4096)
    try:
        p1 = lib.sailor_torch_arena_alloc(a, 100, 16)
        p2 = lib.sailor_torch_arena_alloc(a, 100, 16)
        assert p1 != p2 and p1 % 16 == 0 and p2 % 16 == 0
        assert lib.sailor_torch_arena_alloc(a, 8192, 16)  # a new page
        lib.sailor_torch_arena_reset(a)
        assert lib.sailor_torch_arena_alloc(a, 100, 16) == p1  # the bump pointer reset
    finally:
        lib.sailor_torch_arena_destroy(a)


def _allocator_script(mod):
    """tests/test_native.py's pool and multipool cases as one script: the
    stats after every step."""
    out = []
    p = mod.Pool(block_size=48, blocks_per_page=8)
    ptrs = [p.alloc() for _ in range(20)]  # three pages
    out += [len(set(ptrs)), p.stats()]
    p.free(ptrs.pop())
    out.append(p.stats())
    ptrs.append(p.alloc())
    out.append(p.stats())
    for q in ptrs[::2]:
        p.free(q)
    out.append(p.stats())
    p.destroy()
    mp = mod.MultiPool()
    sizes = [1, 16, 17, 24, 100, 1000, 4096, 65536, 65537, 1 << 20, 3000, 8]
    blocks = [(mp.alloc(n), n) for n in sizes]
    out.append(mp.stats())
    for q, n in blocks[1::2]:
        mp.free(q, n)
    out.append(mp.stats())
    for q, n in blocks[::2]:
        mp.free(q, n)
    out.append(mp.stats())
    mp.destroy()
    return out


def test_allocator_stats_match_reference():
    if not jax_nb.available():
        pytest.fail("the JAX package's native library did not build")
    got = _allocator_script(nb)
    assert got == _allocator_script(jax_nb)
    assert got[0] == 20 and got[1]["used"] == 20 and got[1]["pages"] == 3
    assert got[-3]["reserved_bytes"] > (1 << 20) and got[-1]["used"] == 0


def _soup():
    m = jax_primitives.uv_sphere(1.0, rings=12, sectors=20)
    v, i = m.positions, m.indices
    return v[i[:, 0]], v[i[:, 1]], v[i[:, 2]]


@pytest.mark.parametrize("leaf_size", [4, 7])
def test_bvh_build_matches_reference(leaf_size):
    v0, v1, v2 = _soup()
    got = nb.bvh_build(v0, v1, v2, leaf_size)
    want = jax_nb.bvh_build(v0, v1, v2, leaf_size)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].view(np.int32), want[k].view(np.int32), k)
    # tests/test_native.py::test_native_bvh_structure
    n = len(got["node_min"])
    assert n > 1
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    np.testing.assert_allclose(got["node_min"][0], lo, atol=1e-6)
    covered = np.zeros(len(v0), bool)
    for k in range(n):
        c = got["node_count"][k]
        if c > 0:
            ids = got["order"][got["node_start"][k]:got["node_start"][k] + c]
            assert not covered[ids].any()
            covered[ids] = True
    assert covered.all()


# --- load_async -------------------------------------------------------------------


def _assets(tmp_path):
    from sailor_tpu_torch.utils.png import encode_png

    img = np.random.default_rng(0).integers(0, 255, (16, 24, 3), dtype=np.uint8)
    (tmp_path / "tex.png").write_bytes(encode_png(img))
    (tmp_path / "red.mat").write_text("uniformsVec4:\n  material.albedo: [0.9, 0.1, 0.1, 1]\n")
    with open(os.path.join(REPO, "content", "Editor.world")) as f:
        (tmp_path / "Editor.world").write_text(f.read())
    return ["tex.png", "red.mat", "Editor.world"]


def test_load_async_equals_load(tmp_path):
    names = _assets(tmp_path)
    sync = AssetRegistry(str(tmp_path))
    sync.scan_content_folder()
    asyn = AssetRegistry(str(tmp_path))
    asyn.scan_content_folder()
    handles = [load_async(asyn, str(tmp_path / n)) for n in names]
    got = [h.wait(WAIT) for h in handles]
    assert all(h.is_done() for h in handles)
    for name, g in zip(names, got):
        assert assets_equal(g, sync.load(str(tmp_path / name))), name
    missing = load_async(asyn, str(tmp_path / "nothing.png"))
    with pytest.raises(OSError):
        missing.wait(WAIT)


_EXIT_PROBE = """
import sys
sys.path.insert(0, {repo!r})
from sailor_tpu_torch.assets.registry import AssetRegistry, load_async
reg = AssetRegistry({root!r})
reg.scan_content_folder()
h = load_async(reg, {path!r})
print(type(h.wait(60)).__name__)
load_async(reg, {path!r})  # a load still queued or running at exit
"""


def test_process_exits_with_the_scheduler_alive(tmp_path):
    _assets(tmp_path)
    code = _EXIT_PROBE.format(repo=REPO, root=str(tmp_path), path=str(tmp_path / "red.mat"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "MaterialAsset"


def test_load_scheduler_is_shared():
    assert registry_mod._get_scheduler() is registry_mod._get_scheduler()


# --- benchmarks and the console ----------------------------------------------------


@pytest.mark.parametrize("name", benchmarks.ALL)
def test_benchmark_suite_passes(name):
    out = benchmarks.run(name, "cpu")
    assert re.fullmatch(rf"{name}\.benchmark PASSED in [0-9.]+ms — .+", out), out


def test_console_commands():
    """tests/test_engine_aux.py::test_console_commands on the port, with
    the multipool line and every benchmark command."""
    con = Console(world=World(device="cpu"))
    mp = nb.MultiPool()
    out = con.execute("stats.memory")
    assert "transform pool: 0/1024" in out
    assert re.search(r"native multipool: 0/\d+ blocks, \d+ pages, [0-9.]+MB reserved", out)
    assert "unknown command" in con.execute("frobnicate")
    for name in benchmarks.ALL:
        assert f"{name}.benchmark PASSED" in con.execute(f"{name}.benchmark")
    mp.destroy()


# --- the profiler -------------------------------------------------------------------


def _scopes(mod):
    mod.end_frame()

    @mod.profile_function
    def leaf():
        return 3

    with mod.profile_scope("frame"):
        for _ in range(3):
            with mod.profile_scope("inner"):
                leaf()
    with mod.profile_scope("synced", sync=True):
        pass
    mod.enable(False)
    with mod.profile_scope("hidden"):
        pass
    mod.enable(True)
    first = mod.end_frame()
    return first, mod.end_frame()


def test_profiler_matches_reference():
    got, got_next = _scopes(profiler)
    want, want_next = _scopes(jax_profiler)
    assert got_next == want_next == {}
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}
    assert set(got) == {"frame", "inner", "synced", "_scopes.<locals>.leaf"}
    for count, total, peak in got.values():
        assert 0 <= peak <= total


def test_device_trace_writes_a_trace(tmp_path):
    import torch

    with profiler.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
