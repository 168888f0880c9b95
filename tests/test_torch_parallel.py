"""Multi-device rendering (sailor_tpu_torch.parallel and
FrameGraph.process_sharded) on the CPU, against the port's single-device
passes and the JAX package's sharded passes on the conftest's 8 virtual
CPU devices (the reference runs its helpers under ``shard_map``).

Tolerances:
- the sharded helpers (the boundary-exact upsample, the row halo,
  ``hbao_sharded``, ``blur_rows_sharded``) at 2, 4 and 8 shards: equal to
  the port's whole-frame pass sliced, bit for bit; equal to the
  reference's sharded helper bit for bit, except ``hbao_sharded``, held to
  the reference as test_torch_post.py holds ``hbao`` (its compiled pass
  clamps a few border taps differently: within 1e-5 relative more than 16
  px from the border and on >= 99.5% of all pixels), and
  ``blur_rows_sharded``, within 1e-6 relative (the reference's compiled
  sharded blur is not bit-equal to its own compiled whole pass, which the
  port's ``blur_1d`` equals);
- ``shift_viewport_rows``: the shifted constants equal the reference's
  under ``shard_map`` bit for bit (both fused multiply-adds);
- ``process_sharded`` on DefaultRenderer.renderer at
  tests/test_parallel_graph.py's W, H = 128, 256 and ``_CONFIG`` over 8
  CPU shards, two frames with the state threaded through: against the
  reference's ``process_sharded``, Main within 1e-4 (absolute and
  relative) and Final within 1e-4 on every pixel (measured 8.1e-5 and
  1.3e-5 on both frames), ``avg_luminance`` within 1e-5 relative
  (measured 2.7e-7); against the port's own single-device graph, Main and
  Final within 1e-4 (measured 7.2e-7 on 521 pixels and 1.8e-7: the
  shards' shifted depth planes round some depths 1 ulp apart), the
  exposure equal; the row-local state (``hiz/*``, ``sky/buf``) comes back
  at full height and the CSM maps of the cached frame 2 equal the
  single-device cache;
- a live particle trail through 4 shards: full height in the state and
  equal to the single-device trail within 1e-6;
- ``sharded_forward_frame`` at 128 x 512 over 8 shards (the reference
  needs whole 64-row tile rows a shard): within 2e-3 of the reference's
  LDR frame (measured 6.1e-4 at most, 5.1e-8 on average);
- ``sharded_path_trace`` with caller uniforms: bit-equal to
  ``trace_rays`` on the same rays; without them, within the reference's
  mean bound (tests/test_parallel.py);
- a shard that raises makes ``process_sharded`` raise that error within
  seconds, and the others stop at their next collective.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from sailor_tpu.kernels import blur as j_blur
from sailor_tpu.kernels import postprocess as j_pp
from sailor_tpu.kernels import sampling as j_sampling
from sailor_tpu.raster import setup as j_setup
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.framegraph import nodes as t_nodes
from sailor_tpu_torch.kernels import blur, postprocess as pp, sampling
from sailor_tpu_torch.parallel import make_mesh, mesh as t_mesh
from sailor_tpu_torch.raster import setup as t_setup
from test_torch_scenes import jax_scene, scene_arrays, torch_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDERER = os.path.join(REPO, "content", "DefaultRenderer.renderer")
SHARDS = [2, 4, 8]
INV_PROJ = np.array([[0.8660255, 0, 0, 0], [0, 0.5773503, 0, 0], [0, 0, 0, -1],
                     [0, 0, 9.993333, 0.006666666]], np.float32)


def _jax_sharded(fn, x, n):
    """``fn`` over the row slices of ``x`` under the reference's shard_map."""
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("screen",))
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=P("screen"), out_specs=P("screen"),
                          check_vma=False))
    return np.asarray(f(jnp.asarray(x)))


def _port_sharded(fn, x, n):
    """``fn(slice, comm)`` over the row slices of ``x`` on n CPU shards."""
    h = x.shape[0] // n
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = make_mesh(n, device="cpu").run(
        lambda comm: fn(t[comm.index * h:(comm.index + 1) * h], comm))
    return torch.cat(out).numpy()


def _image(rows, cols, ch=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, cols) if ch is None else (rows, cols, ch)
    return rng.uniform(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("w", [-0.375, 0.1234567, 1.0 / 3.0, 17.0])
def test_fma_scalar_matches_compiled_reference(w):
    """``math3d.fma_scalar`` (the blur's and the upsample's blend) equals
    the reference's compiled a * w + c, which XLA:CPU fuses."""
    from sailor_tpu_torch.core.math3d import fma_scalar

    a, c = _image(64, 48, 3, seed=1) - 2.0, _image(64, 48, 3, seed=2)
    want = np.asarray(jax.jit(lambda a, c: a * jnp.float32(w) + c)(a, c))
    got = fma_scalar(torch.from_numpy(a), w, torch.from_numpy(c))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("factor,ch", [(2, 3), (4, None)])
def test_upsample_sharded(n, factor, ch):
    h, w = 6, 10
    src = _image(n * h, w, ch, seed=n)
    dst = (h * factor, w * factor)
    got = _port_sharded(lambda x, c: sampling.upsample_bilinear_pow2_sharded(x, dst, c), src, n)
    whole = sampling.upsample_bilinear_pow2(torch.from_numpy(src),
                                            (n * h * factor, w * factor)).numpy()
    np.testing.assert_array_equal(got, whole)
    want = _jax_sharded(
        lambda x: j_sampling.upsample_bilinear_pow2_sharded(x, dst, "screen", n), src, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SHARDS)
def test_exchange_row_halo(n):
    img = _image(n * 8, 12, 2, seed=7)
    r = 3
    got = _port_sharded(lambda x, c: pp.exchange_row_halo(x, r, c), img, n)
    want = _jax_sharded(lambda x: j_pp.exchange_row_halo(x, r, "screen", n), img, n)
    np.testing.assert_array_equal(got, want)
    # every slice's halo is its true neighbours (the edge row past the frame)
    padded = np.concatenate([img[:1].repeat(r, 0), img, img[-1:].repeat(r, 0)])
    for i, part in enumerate(np.split(got, n)):
        np.testing.assert_array_equal(part, padded[i * 8:i * 8 + 8 + 2 * r])


@pytest.mark.parametrize("n", SHARDS)
def test_blur_rows_sharded(n):
    img = _image(n * 16, 24, seed=3)
    got = _port_sharded(lambda x, c: blur.blur_rows_sharded(x, 4, c), img, n)
    np.testing.assert_array_equal(got, blur.blur_1d(torch.from_numpy(img), 4, 0).numpy())
    want = _jax_sharded(lambda x: j_blur.blur_rows_sharded(x, 4, "screen", n), img, n)
    # the reference's compiled sharded blur rounds some pair sums apart
    # from its own compiled whole pass (which the port's blur_1d equals):
    # 1 ulp on ~13% of the elements
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _linear_depth(rows, cols):
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    ld = 4.0 + 2.0 * np.sin(xx * 0.11) * np.cos(yy * 0.07) + 0.5 * (xx > cols // 2)
    ld[rows // 3:rows // 3 + 9, cols // 4:cols // 4 + 14] -= 2.5  # an occluder
    return ld.astype(np.float32)


@pytest.mark.parametrize("n", SHARDS)
def test_hbao_sharded(n):
    h, w = 32, 48
    H = n * h
    ld = _linear_depth(H, w)
    kw = dict(radius=0.6, power=1.6)
    got = _port_sharded(lambda x, c: pp.hbao_sharded(
        x, torch.from_numpy(INV_PROJ), height=h, width=w, comm=c, row0=c.index * h,
        full_height=H, **kw), ld, n)
    whole = pp.hbao(torch.from_numpy(ld), torch.from_numpy(INV_PROJ), height=H, width=w,
                    **kw).numpy()
    np.testing.assert_array_equal(got, whole)

    def ref(x):
        row0 = jax.lax.axis_index("screen") * h
        return j_pp.hbao_sharded(x, jnp.asarray(INV_PROJ), height=h, width=w, axis_name="screen",
                                 n_shards=n, row0=row0, full_height=H, **kw)

    want = _jax_sharded(ref, ld, n)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert rel[16:-16, 16:-16].max() <= 1e-5
    assert (rel <= 1e-5).mean() >= 0.995
    assert 0.3 < got.mean() < 1.0


@pytest.mark.parametrize("n", SHARDS)
def test_shift_viewport_rows_matches_reference(n):
    js = jax_scene(128, 32 * n, 8, 6)
    tri, _ = j_setup.triangle_setup(js.geometry, js.frame.view_projection, width=128,
                                    height=32 * n, cull="back")
    h = 32

    def body(e, z):
        row0 = jax.lax.axis_index("screen") * h
        t = j_setup.shift_viewport_rows(tri.replace(edge=e[0], zplane=z[0]), row0)
        return t.edge[None], t.zplane[None]

    mesh = JMesh(np.asarray(jax.devices()[:n]), ("screen",))
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                          out_specs=(P("screen"), P("screen")), check_vma=False))
    e, z = (np.asarray(a) for a in f(tri.edge[None], tri.zplane[None]))
    ts = t_setup.TriangleSetup(
        edge=torch.tensor(np.asarray(tri.edge)), zplane=torch.tensor(np.asarray(tri.zplane)),
        valid=torch.tensor(np.asarray(tri.valid)), src_id=torch.tensor(np.asarray(tri.src_id)),
        zmax=torch.tensor(np.asarray(tri.zmax)))
    for i in range(n):
        s = t_setup.shift_viewport_rows(ts, i * h)
        np.testing.assert_array_equal(s.edge.numpy(), e[i])
        np.testing.assert_array_equal(s.zplane.numpy(), z[i])
        np.testing.assert_array_equal(s.edge[..., :2].numpy(), np.asarray(tri.edge)[..., :2])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_collectives_are_ordered_and_permute(n):
    """The collectives' results over n CPU shards, which take host turns as
    the shards of one card do."""
    mesh = make_mesh(n, device="cpu")
    root = n // 2

    def body(comm):
        x = torch.full((2,), float(comm.index + 1))
        fwd = [(i, i + 1) for i in range(n - 1)]
        return (comm.all_gather(x[None]), comm.psum(x), comm.ppermute(x, fwd),
                comm.gather(x[None], root=root), comm.neighbour_rows(x[:1], x[1:]))

    out = mesh.run(body)
    for i, (ag, ps, pm, g, (prev, nxt)) in enumerate(out):
        np.testing.assert_array_equal(ag[:, 0].numpy(), np.arange(1, n + 1))
        np.testing.assert_array_equal(ps.numpy(), [n * (n + 1) // 2] * 2)
        np.testing.assert_array_equal(pm.numpy(), [i, i])  # shard 0 receives zeros
        assert (g is None) == (i != root)
        if i == root:
            np.testing.assert_array_equal(g[:, 0].numpy(), np.arange(1, n + 1))
        assert (prev is None) == (i == 0) and (nxt is None) == (i == n - 1)
        if prev is not None:
            np.testing.assert_array_equal(prev.numpy(), [i])  # shard i-1's bottom: i
        if nxt is not None:
            np.testing.assert_array_equal(nxt.numpy(), [i + 2])  # shard i+1's top
    assert mesh.placement() == ["cpu"] * n


# --- the whole DefaultRenderer frame over 8 shards ---------------------------------


def _graph_scenes():
    """tests/test_parallel_graph.py's scene and its second frame (the CSM
    cache hits) in both packages."""
    import test_parallel_graph as tpg

    js = tpg._scene()
    js2 = js.replace(frame=js.frame.replace(delta_time=js.frame.delta_time + 1e-5))
    return tpg, [js, js2]


def _frames(run, fg, scenes):
    state = fg.initial_state()
    out = []
    for scene in scenes:
        fg.prepare(scene, state)
        t, state = run(fg, scene, state)
        out.append(({k: np.asarray(t[k]) for k in ("Main", "Final")},
                    {k: np.asarray(v) for k, v in state.items()}))
    return out


@pytest.fixture(scope="module")
def graph_frames():
    from sailor_tpu.framegraph import FrameGraph as JFrameGraph
    from sailor_tpu.framegraph import FrameGraphAsset as JAsset
    from sailor_tpu.parallel.mesh import make_mesh as j_make_mesh

    tpg, jscenes = _graph_scenes()
    jax.clear_caches()
    jmesh = j_make_mesh(8)
    ref = _frames(lambda fg, s, st: fg.process_sharded(s, st, jmesh),
                  JFrameGraph(JAsset.load(RENDERER), tpg.W, tpg.H, config=dict(tpg._CONFIG)),
                  jscenes)
    jax.clear_caches()
    tscenes = [torch_scene(s) for s in jscenes]
    mesh = make_mesh(8, device="cpu")

    def port(run):
        return _frames(run, FrameGraph(FrameGraphAsset.load(RENDERER), tpg.W, tpg.H,
                                       dict(tpg._CONFIG), device="cpu"), tscenes)

    sharded = port(lambda fg, s, st: fg.process_sharded(s, st, mesh))
    single = port(lambda fg, s, st: fg.process(s, st))
    return sharded, single, ref


def test_process_sharded_matches_reference(graph_frames):
    sharded, _, ref = graph_frames
    for (got, gs), (want, ws) in zip(sharded, ref):
        np.testing.assert_allclose(got["Main"], want["Main"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["Final"], want["Final"], atol=1e-4)
        np.testing.assert_allclose(gs["avg_luminance"], ws["avg_luminance"], rtol=1e-5)
        # the key's geometry signature sums in each framework's order
        np.testing.assert_allclose(gs["csm/key"], ws["csm/key"], rtol=1e-5, atol=1e-6)


def test_process_sharded_matches_single_device(graph_frames):
    sharded, single, _ = graph_frames
    for (got, gs), (want, ws) in zip(sharded, single):
        np.testing.assert_allclose(got["Main"], want["Main"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["Final"], want["Final"], atol=1e-4)
        np.testing.assert_allclose(gs["avg_luminance"], ws["avg_luminance"], rtol=1e-5)


def test_process_sharded_threads_full_state(graph_frames):
    sharded, single, ref = graph_frames
    (_, s1), (_, s2) = sharded
    (_, w1), (_, w2) = single
    for k in ("csm/maps", "csm/evsm", "csm/key", "avg_luminance", "sky/buf", "sky/key",
              "hiz/mip0"):
        assert s1[k].shape == w1[k].shape, k
    assert s1["sky/buf"].shape[0] == 256 and s1["hiz/mip0"].shape[0] == 256 // 4
    # frame 2 hits the CSM cache: the maps are frame 1's, as on one device
    np.testing.assert_array_equal(s2["csm/maps"], s1["csm/maps"])
    np.testing.assert_array_equal(s2["csm/maps"], w2["csm/maps"])
    np.testing.assert_array_equal(ref[1][1]["csm/maps"].shape, s2["csm/maps"].shape)
    np.testing.assert_allclose(s2["csm/maps"], ref[1][1]["csm/maps"], atol=1e-6)


def test_sharding_needs_tile_rows():
    fg = FrameGraph(FrameGraphAsset.load(RENDERER), 64, 96, device="cpu")
    with pytest.raises(ValueError, match="32-px tile rows"):
        fg.process_sharded(None, {}, make_mesh(2, device="cpu"))


def test_particle_trail_shards(monkeypatch):
    from sailor_tpu_torch.scenes import flagship_scene

    graph = ("frame:\n - name: DepthPrepass\n - name: LinearizeDepth\n"
             " - name: LightCulling\n - name: RenderScene\n - name: Particles\n"
             "   size: 0.3\n   traceDecay: 0.5\n - name: EyeAdaptation\n")
    w, h = 64, 128
    scene = flagship_scene(w, h, 4, 4, device="cpu")
    rng = np.random.default_rng(4)
    live = {"particles/pos": torch.tensor(rng.uniform(-3, 3, (64, 3)), dtype=torch.float32),
            "particles/vel": torch.tensor(rng.uniform(-1, 1, (64, 3)), dtype=torch.float32),
            "particles/life": torch.full((64,), 2.0)}
    mesh = make_mesh(4, device="cpu")
    outs = []
    for run in (lambda fg, st: fg.process(scene, st),
                lambda fg, st: fg.process_sharded(scene, st, mesh)):
        fg = FrameGraph(FrameGraphAsset.from_yaml(graph), w, h, {"bin_capacity": 128},
                        device="cpu")
        state = dict(fg.initial_state(), **live)
        for _ in range(2):
            fg.prepare(scene, state)
            t, state = run(fg, state)
        outs.append((t["Main"], state["particles/trail"]))
    (main1, trail1), (main4, trail4) = outs
    assert trail4.shape == (h, w, 3) and float(trail1.sum()) > 0.0
    np.testing.assert_allclose(trail4.numpy(), trail1.numpy(), atol=1e-6)
    np.testing.assert_allclose(main4.numpy(), main1.numpy(), atol=1e-4, rtol=1e-4)


def test_failing_shard_raises_promptly(monkeypatch):
    """A shard that raises in a node: process_sharded re-raises its error,
    and the other shards stop at their next collective; the whole run
    is bounded by the mesh's timeout even if a shard never arrives (or
    never hands its host turn on)."""
    from sailor_tpu_torch.scenes import flagship_scene

    scene = flagship_scene(64, 128, 4, 4, device="cpu")
    fg = FrameGraph(FrameGraphAsset.from_nodes(
        ["DepthPrepass", "LinearizeDepth", "LightCulling", "RenderScene", "EyeAdaptation"]),
        64, 128, {"bin_capacity": 128}, device="cpu")
    orig = t_nodes.RenderSceneNode.process

    def flaky(self, ctx, targets):
        if ctx.comm.index == 2:
            raise RuntimeError("shard 2 failed")
        return orig(self, ctx, targets)

    monkeypatch.setattr(t_nodes.RenderSceneNode, "process", flaky)
    result = {}

    def mesh(timeout):
        return make_mesh(4, device="cpu", timeout=timeout)

    def go():
        try:
            fg.process_sharded(scene, fg.initial_state(), mesh(30.0))
        except Exception as e:  # noqa: BLE001 - the test reads it
            result["error"] = e

    t0 = time.monotonic()
    th = threading.Thread(target=go, daemon=True)
    th.start()
    th.join(60.0)
    assert not th.is_alive(), "process_sharded hung"
    assert time.monotonic() - t0 < 30.0
    assert isinstance(result.get("error"), RuntimeError)
    assert "shard 2 failed" in str(result["error"])

    # a shard that never reaches the collective: the others time out
    def stuck(self, ctx, targets):
        if ctx.comm.index == 1:
            time.sleep(6.0)
        return orig(self, ctx, targets)

    monkeypatch.setattr(t_nodes.RenderSceneNode, "process", stuck)
    with pytest.raises(t_mesh.CollectiveError):
        fg.process_sharded(scene, fg.initial_state(), mesh(1.0))
    # the straggler ends at its next collective; let it, before the test ends
    deadline = time.monotonic() + 60.0
    while (any(t.name.startswith("shard-") for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not any(t.name.startswith("shard-") for t in threading.enumerate())


# --- sharded_forward_frame and sharded_path_trace ---------------------------------


def test_sharded_forward_frame_matches_reference():
    import __graft_entry__ as g
    from sailor_tpu.parallel import make_mesh as j_make_mesh
    from sailor_tpu.parallel import sharded_forward_frame as j_forward

    w, h = 128, 8 * 64  # the reference needs whole 64-row tile rows a shard
    js = g._demo_scene(w, h, num_lights=8)
    jax.clear_caches()
    want = np.asarray(j_forward(js, width=w, height=h, mesh=j_make_mesh(8)))
    jax.clear_caches()
    stats = {}
    got = t_mesh.sharded_forward_frame(torch_scene(js), width=w, height=h,
                                       mesh=make_mesh(8, device="cpu"), stats=stats).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    assert len(stats["bin_overflow"]) == 8
    assert np.abs(got - want).max() <= 2e-3, np.abs(got - want).max()
    assert got.std() > 0.02


def _trace_scene():
    from sailor_tpu_torch.assets import primitives
    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.raytracing import path_tracer as pt

    soup = primitives.merge([(primitives.plane(20.0), np.eye(4)),
                             (primitives.cube(2.0), np.eye(4))])
    scene = pt.scene_from_mesh(soup, device="cpu")
    cam = torch.tensor([0.0, 3.0, 6.0])
    view = m3.look_at(cam, torch.tensor([0.0, 0.5, 0.0]), torch.tensor([0.0, 1.0, 0.0]))
    proj = m3.perspective(np.pi / 3, 1.0, 0.1, 50.0, device="cpu")
    return scene, cam, view, proj


def test_sharded_path_trace_with_uniforms_equals_trace_rays():
    from sailor_tpu_torch.raytracing import path_tracer as pt

    scene, cam, view, proj = _trace_scene()
    w, h, spp, bounces = 32, 64, 2, 2
    u = torch.rand((spp, 5 * bounces, w * h), generator=torch.Generator().manual_seed(5))
    got = t_mesh.sharded_path_trace(scene, cam, view, proj, width=w, height=h,
                                    mesh=make_mesh(8, device="cpu"), spp=spp,
                                    max_bounces=bounces, uniforms=u)
    o, d = t_mesh.global_rows_rays(cam, view, proj, width=w, rows=range(h), height=h)
    want, _ = pt.trace_rays(scene, o, d, spp=spp, max_bounces=bounces, uniforms=u)
    np.testing.assert_array_equal(got.numpy(), want.reshape(h, w, 3).numpy())
    assert float(got.mean()) > 0.0


def test_sharded_path_trace_mean_matches_single_device():
    from sailor_tpu_torch.raytracing import path_tracer as pt

    scene, cam, view, proj = _trace_scene()
    w, h = 32, 64
    a = t_mesh.sharded_path_trace(scene, cam, view, proj, width=w, height=h,
                                  mesh=make_mesh(8, device="cpu"), spp=2, max_bounces=2,
                                  seed=3).numpy()
    b, _ = pt.render(scene, cam, view, proj, width=w, height=h, spp=8, max_bounces=2, seed=3)
    b = b.numpy()
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 0.25 * max(b.mean(), 1e-3)
    # shards draw from their own generators: the slices are not copies
    assert not np.array_equal(a[:8], a[8:16])


def test_shard_seed_rule():
    assert t_mesh.shard_seed(0, 0) == 0
    assert len({t_mesh.shard_seed(s, i) for s in range(3) for i in range(8)}) == 24
