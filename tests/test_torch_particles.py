"""The particle system against the JAX package's, on the CPU
(``assets/particles.py``, ``kernels/particles.py`` and the Particles node).

- ``ParticlesAsset``: saved by one package and loaded by the other, both
  ways (the header and the binary byte for byte); ``bake_fountain`` equal.
- ``sample_baked``: within 1e-6 of the reference's compiled function
  (measured: equal; the lerp is fused as fma(s1, 1 - a, s2 * a)).
- ``splat_particles``: the reference's ``test_splat_matches_oracle`` and
  depth-occlusion cases and a 256x128 case with 512 particles (a depth
  band with fractional soft-depth fades; again at a height of 120, not a
  multiple of 16), within 1e-4 relative plus 1e-6 absolute on >= 99.9% of the
  pixels and exactly 0 where the reference's is 0 (measured: equal on
  every pixel, ROADMAP C 2); the oracle case also against the brute-force
  oracle of tests/test_particles.py. In the free depth-occlusion case the
  reference's binning lists its one particle twice in the last tile
  (ROADMAP C 5): the test checks that count and holds the port to the
  reference's splat with that tile's double add undone.
- The Particles node: test_framegraph_baked_particles's 64x64 graph for 3
  frames with the baked asset's trail, and a live simulation from
  ``particles/pos|vel|life`` in the state: Depth and TriId exact, Main
  within 1e-4 relative (to max(|ref|, 1e-3)) on >= 99.9% of the pixels,
  Final within 2/255, the trail and the simulation state within 1e-6
  relative (measured: the trail equal, positions within an ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import particles as jparticles
from sailor_tpu.core import math3d as jm3
from sailor_tpu.kernels import particles as jsplat
from sailor_tpu_torch.assets import particles
from sailor_tpu_torch.kernels import particles as splat
from test_particles import _oracle_splat
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_asset_files_cross_both_ways(tmp_path):
    port = particles.bake_fountain(frames=12, n=16, fps=24)
    ref = jparticles.bake_fountain(frames=12, n=16, fps=24)
    np.testing.assert_array_equal(port.data, ref.data)
    port.save(str(tmp_path / "p.particles"))
    ref.save(str(tmp_path / "r.particles"))
    for ext in (".particles", ".bin"):
        a, b = (tmp_path / f"p{ext}").read_bytes(), (tmp_path / f"r{ext}").read_bytes()
        assert a.replace(b"p.bin", b"r.bin") == b
    for loaded, src in ((jparticles.ParticlesAsset.load(str(tmp_path / "p.particles")), port),
                        (particles.ParticlesAsset.load(str(tmp_path / "r.particles")), ref)):
        assert (loaded.fps, loaded.frames, loaded.n) == (24, 12, 16)
        assert (loaded.trace_decay, loaded.trace_frames) == (src.trace_decay, src.trace_frames)
        np.testing.assert_array_equal(loaded.data, src.data)
    (tmp_path / "bad.particles").write_text("frames: 3\nn: 2\nbinary: r.bin\n")
    with pytest.raises(ValueError, match="expected 3x2x20"):
        particles.ParticlesAsset.load(str(tmp_path / "bad.particles"))


@pytest.mark.parametrize("t", [0.0, 0.41, 1.234, 7.77])
def test_sample_baked_matches_reference(t):
    asset = jparticles.bake_fountain(frames=30, n=300, fps=30)
    want = jax.jit(jparticles.sample_baked, static_argnums=(2, 3))(
        jnp.asarray(asset.data), jnp.asarray(t, jnp.float32), 30, 30)
    got = particles.sample_baked(_t(asset.data), torch.tensor(t), 30, 30)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_baked_playback_interpolates():
    data = np.zeros((2, 1, particles.RECORD), np.float32)
    data[:, :, 0] = 1.0
    data[0, 0, 1] = data[0, 0, 2] = 0.5
    data[0, 0, 8:12] = [1, 2, 3, 1]
    data[0, 0, 16:20] = [3, 4, 5, 1]
    data[0, 0, 12:15] = [1, 0, 0]
    pos, size, col = particles.sample_baked(_t(data), 0.5 / 30.0, 30, 2)
    np.testing.assert_allclose(pos[0].numpy(), [0.5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(col[0].numpy(), [2, 3, 4, 1], atol=1e-6)
    assert float(size[0]) == pytest.approx(0.5)
    data[0, 0, 0] = 0.0
    assert float(particles.sample_baked(_t(data), 0.0, 30, 2)[2][0, 3]) == 0.0


def _camera(width, height):
    cam = jnp.asarray([0.0, 1.0, 6.0])
    view = jm3.look_at(cam, jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jm3.perspective(jnp.pi / 3, width / height, 0.1, 60.0)
    return cam, view, proj


def _splat_case(name):
    """(positions, radii, colors, vp, proj, depth, W, H) of a test case."""
    if name == "occlusion_free" or name == "occlusion_wall":
        w = h = 32
        pos = np.asarray([[0.0, 1.0, 0.0]], np.float32)
        radii = np.asarray([0.4], np.float32)
        colors = np.asarray([[1, 1, 1, 1]], np.float32)
        depth = np.zeros((h, w), np.float32) if name == "occlusion_free" else \
            np.full((h, w), 0.999, np.float32)
    else:
        w, h, n, seed = {"oracle": (64, 64, 40, 5), "band": (256, 128, 512, 7),
                         "band_h120": (256, 120, 512, 7)}[name]
        rng = np.random.default_rng(seed)
        pos = np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 2.5, n),
                        rng.uniform(-2, 2, n)], 1).astype(np.float32)
        radii = rng.uniform(0.05, 0.5, n).astype(np.float32)
        colors = rng.uniform(0.2, 2.0, (n, 4)).astype(np.float32)
        pos[0] = [0, 1, 20]   # behind the camera
        colors[1, 3] = 0.0    # dead
        depth = np.zeros((h, w), np.float32)
        depth[h * 5 // 8:, :] = 0.9  # a near wall on the bottom rows
        if name.startswith("band"):
            depth[:, : w // 4] = rng.uniform(0.0, 1.0, (h, w // 4)).astype(np.float32)
    _, view, proj = _camera(w, h)
    return pos, radii, colors, np.asarray(proj @ view), np.asarray(proj), depth, w, h


@pytest.mark.parametrize("name", ["oracle", "occlusion_free", "occlusion_wall", "band",
                                  "band_h120"])
def test_splat_matches_reference(name):
    pos, radii, colors, vp, proj, depth, w, h = _splat_case(name)
    want = np.asarray(jsplat.splat_particles(
        jnp.asarray(pos), jnp.asarray(radii), jnp.asarray(colors), vp, proj,
        jnp.asarray(depth), width=w, height=h))
    stats = {}
    got = splat.splat_particles(_t(pos), _t(radii), _t(colors), _t(vp), _t(proj), _t(depth),
                                width=w, height=h, stats=stats).numpy()
    assert got.shape == want.shape == (h, w, 3)
    if name == "occlusion_free":
        # one particle over four tiles and no sentinel key: the reference's
        # bin_all counts its last tile one too high (its binary search
        # overshoots past the last key) and its extra slot re-reads the
        # particle, so the reference adds it twice in tile (1, 1)
        # (ROADMAP C 5); the port lists it once there
        jpasses = _reference_bins(pos, radii, colors, vp, proj, w, h)
        assert np.asarray(jpasses[0][1]).tolist() == [[1, 1], [1, 2]]
        want = want.copy()
        want[16:, 16:] *= 0.5  # exact: the two adds of x give 2x
    close = (np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6).all(-1)
    assert close.mean() >= 0.999
    np.testing.assert_array_equal(got[want == 0], 0.0)
    assert int(stats["slots"]) > 0
    assert (int(stats["overflow"]) > 0) == name.startswith("band")  # 512 crowd some tiles
    if name == "oracle":
        np.testing.assert_allclose(got, _oracle_splat(pos, radii, colors, vp, proj, depth, w, h),
                                   atol=2e-4, rtol=1e-3)
        assert int(stats["valid"]) == 38  # one behind the camera, one dead
    if name == "occlusion_free":
        assert got.sum() > 0.1
    if name == "occlusion_wall":
        assert got.sum() < 1e-6
    if name.startswith("band"):
        assert (got > 0).any(-1)[:, : w // 4].mean() > 0.02  # fractional fades on screen


def _reference_bins(pos, radii, colors, vp, proj, w, h):
    """The reference's bin_all passes for a splat's particles, from the
    port's projection (equal to the reference's on these inputs)."""
    from sailor_tpu.raster.setup import bin_all

    sx, sy, r, _, valid = splat.project_particles(_t(pos), _t(radii), _t(colors), _t(vp),
                                                  _t(proj), width=w, height=h)
    aabb = tuple(jnp.asarray(a.numpy()) for a in (sx - r, sx + r, sy - r, sy + r))
    return bin_all(jnp.asarray(valid.numpy()), aabb, tiles_x=-(-w // 16),
                   tiles_y=-(-h // 16), tile_w=16, tile_h=16, capacity=64, rounds=1,
                   big_capacity=16)[0]


# --- the Particles node -----------------------------------------------------------

W = H = 64
GRAPH = ("frame:\n - name: DepthPrepass\n - name: LinearizeDepth\n"
         " - name: LightCulling\n - name: RenderScene\n"
         " - name: Particles\n{params}"
         " - name: EyeAdaptation\n")
CONFIG = {"bin_capacity": 64, "bin_rounds": 1}
KEYS = ("Depth", "TriId", "Main", "Final")


def _scenes():
    """test_framegraph_baked_particles's scene in both packages."""
    from sailor_tpu.assets import primitives as jprimitives
    from sailor_tpu.kernels.lights import DIRECTIONAL, Lights
    from sailor_tpu.raster.setup import Geometry
    from sailor_tpu.rhi.scene_view import SceneView
    from sailor_tpu.rhi.types import FrameData
    from test_torch_scenes import torch_scene

    soup = jprimitives.merge([(jprimitives.plane(8.0), np.eye(4))])
    geo = Geometry(**{k: jnp.asarray(soup[k]) for k in ("position", "normal", "uv", "color",
                                                         "indices", "material_id")})
    lights = Lights.from_host(types=[DIRECTIONAL], positions=[[0, 0, 0]],
                              directions=[[0.3, -1, 0.2]], intensities=[[2, 2, 2]])
    cam, view, proj = _camera(W, H)
    frame = FrameData.create(view, proj, cam, 0.1, 60.0, time=0.4, dt=0.05)
    js = SceneView.create(geo, lights, frame)
    return js, torch_scene(js)


def _at(js, ts, t):
    return (js.replace(frame=js.frame.replace(current_time=jnp.asarray(t, jnp.float32))),
            dataclasses.replace(ts, frame=dataclasses.replace(
                ts.frame, current_time=torch.tensor(t, dtype=torch.float32))))


def _live_state(n=96, seed=4):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(0.2, 2.5, n),
                    rng.uniform(-1.5, 1.5, n)], 1).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    life = rng.uniform(-0.2, 1.0, n).astype(np.float32)  # a few dead from the start
    return {"particles/pos": pos, "particles/vel": vel, "particles/life": life}


def _run_both(params, state_extra, frames):
    from sailor_tpu.framegraph import FrameGraph as JFrameGraph
    from sailor_tpu.framegraph import FrameGraphAsset as JAsset
    from sailor_tpu.kernels import pbr_pallas as j_pk
    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    yaml_text = GRAPH.format(params=params)
    js, ts = _scenes()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    ref, got = [], []
    try:
        jfg = JFrameGraph(JAsset.from_yaml(yaml_text), W, H, config=dict(CONFIG))
        state = dict(jfg.initial_state(), **{k: jnp.asarray(v) for k, v in state_extra.items()})
        for t in frames:
            s, _ = _at(js, ts, t)
            jfg.prepare(s, state)
            tg, state = jfg.process(s, state)
            ref.append(({k: np.asarray(tg[k]) for k in KEYS},
                        {k: np.asarray(v) for k, v in state.items() if k.startswith("particles/")}))
    finally:
        mp.undo()
        jax.clear_caches()
    fg = FrameGraph(FrameGraphAsset.from_yaml(yaml_text), W, H, dict(CONFIG), device="cpu")
    state = dict(fg.initial_state(), **{k: _t(v) for k, v in state_extra.items()})
    for t in frames:
        _, s = _at(js, ts, t)
        fg.prepare(s, state)
        tg, state = fg.process(s, state)
        got.append(({k: tg[k].numpy() for k in KEYS},
                    {k: v.numpy() for k, v in state.items() if k.startswith("particles/")}))
    return got, ref


def _check(got, ref):
    for (gt, gs), (rt, rs) in zip(got, ref):
        for k in ("Depth", "TriId"):
            np.testing.assert_array_equal(gt[k], rt[k], err_msg=k)
        rel = (np.abs(gt["Main"] - rt["Main"]) / np.maximum(np.abs(rt["Main"]), 1e-3)).max(-1)
        assert (rel <= 1e-4).mean() >= 0.999, (rel <= 1e-4).mean()
        assert np.abs(gt["Final"] - rt["Final"]).max() <= 2 / 255
        assert sorted(gs) == sorted(rs)
        for k in rs:
            np.testing.assert_allclose(gs[k], rs[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_baked_particles_node_matches_reference(tmp_path):
    asset = particles.bake_fountain(frames=8, n=24, fps=30)
    path = str(tmp_path / "fx.particles")
    asset.save(path)
    got, ref = _run_both(f"   asset: {path}\n", {}, [0.4, 0.45, 0.5])
    _check(got, ref)
    trail = [s["particles/trail"] for _, s in got]
    assert trail[2].sum() > trail[0].sum() > 0.0  # the decayed history grows


def test_live_particles_node_matches_reference():
    got, ref = _run_both("   gravity: -3.0\n   size: 0.15\n   traceDecay: 0.5\n"
                         "   color: [3.0, 1.0, 0.5]\n", _live_state(), [0.4, 0.45])
    _check(got, ref)
    life = [s["particles/life"] for _, s in got]
    np.testing.assert_allclose(life[1], _live_state()["particles/life"] - 0.1, atol=1e-6)
    main = [t["Main"] for t, _ in got]
    assert np.abs(main[1] - main[0]).max() > 1e-3  # the particles moved
