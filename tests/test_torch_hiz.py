"""DepthHighZ and the HiZ cull: the port's ``kernels/sampling`` min pyramid
and upsample and ``raster/hiz_cull`` against the JAX package's, and the
occlusion scene of ``tests/test_hiz_culling.py`` through both packages'
frame graphs.

Tolerances: ``downsample2x_min``, ``build_min_pyramid`` and
``occlusion_cull`` exact (odd sizes too); ``upsample_bilinear_pow2`` within
1e-6 absolute (inputs in [0, 1)); the occlusion scene over two frames:
Depth, TriId and HiZCulledCount exact (the count > 100 on frame 2, where
the 24 cubes hide behind the wall), Main within 1e-4 relative (to
max(|ref|, 1e-3)) on >= 99.9% of pixels, and the port's frame 2 Main equal
to its frame 1 Main.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.framegraph import FrameGraph as JFrameGraph
from sailor_tpu.framegraph import FrameGraphAsset as JAsset
from sailor_tpu.kernels import sampling as j_sampling
from sailor_tpu.raster import hiz_cull as j_hiz
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels import sampling
from sailor_tpu_torch.raster import hiz_cull
from sailor_tpu_torch.scenes import occlusion_scene
from test_hiz_culling import _GRAPH, H, W, _occlusion_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)
from test_torch_scenes import scene_arrays, torch_scene

SHAPES = [(37, 54), (64, 128), (33, 1), (96, 128, 3)]


def _depth(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_downsample2x_min_matches_jax(shape):
    x = _depth(shape)
    want = np.asarray(j_sampling.downsample2x_min(jnp.asarray(x)))
    np.testing.assert_array_equal(sampling.downsample2x_min(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape,levels", [((37, 54), 8), ((128, 96), 8), ((64, 64), 3)],
                         ids=str)
def test_build_min_pyramid_matches_jax(shape, levels):
    x = _depth(shape, 1)
    want = j_sampling.build_min_pyramid(jnp.asarray(x), levels)
    got = sampling.build_min_pyramid(torch.from_numpy(x), levels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("src,dst", [((32, 64), (128, 256)), ((17, 9, 3), (68, 33)),
                                     ((8, 8), (16, 16)), ((5, 7), (5, 21))], ids=str)
def test_upsample_bilinear_pow2_matches_jax(src, dst):
    x = _depth(src, 2)
    want = np.asarray(j_sampling.upsample_bilinear_pow2(jnp.asarray(x), dst))
    got = sampling.upsample_bilinear_pow2(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occlusion_cull_matches_jax(seed):
    """Random pyramids (a depth with some zero, never-covered texels) and
    random triangles: small, large, off screen, some invalid."""
    rng = np.random.default_rng(seed)
    bw, bh = 200, 120
    depth = rng.random((bh, bw), dtype=np.float32) * 0.5 + 0.4
    depth[rng.random((bh, bw)) < 0.05] = 0.0
    mips = j_sampling.build_min_pyramid(jnp.asarray(depth), 8)[2:]
    flat, offsets, shapes = j_hiz.build_flat_pyramid(mips)
    n = 4000
    x0 = rng.uniform(-40, bw + 40, n).astype(np.float32)
    y0 = rng.uniform(-40, bh + 40, n).astype(np.float32)
    size = np.exp(rng.uniform(0, np.log(300), n)).astype(np.float32)
    aabb = (x0, x0 + size * rng.random(n, dtype=np.float32),
            y0, y0 + size * rng.random(n, dtype=np.float32))
    zmax = rng.random(n, dtype=np.float32)
    valid = rng.random(n) < 0.9
    want = np.asarray(j_hiz.occlusion_cull(
        jnp.asarray(valid), tuple(jnp.asarray(a) for a in aabb), jnp.asarray(zmax), flat,
        offsets=offsets, shapes=shapes, base_w=bw, base_h=bh))
    t_flat, t_off, t_shapes = hiz_cull.build_flat_pyramid(
        sampling.build_min_pyramid(torch.from_numpy(depth), 8)[2:])
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(flat))
    assert (t_off, t_shapes) == (offsets, shapes)
    got = hiz_cull.occlusion_cull(
        torch.from_numpy(valid), tuple(torch.from_numpy(a) for a in aabb),
        torch.from_numpy(zmax), t_flat, offsets=t_off, shapes=t_shapes, base_w=bw, base_h=bh)
    assert 0 < (valid & ~want).sum() < valid.sum()
    np.testing.assert_array_equal(got.numpy(), want)


CONFIG = {"bin_capacity": 256, "bin_rounds": 2, "hiz_culling": True}
KEYS = ("Depth", "TriId", "Main", "HiZCulledCount")


def _frames(fg, scene):
    state = fg.initial_state()
    out = []
    for _ in range(2):
        t, state = fg.process(scene, state)
        out.append({k: np.asarray(t[k]) for k in KEYS})
    return out


@pytest.fixture(scope="module")
def occlusion_frames():
    js = _occlusion_scene()
    jax.clear_caches()
    try:
        ref = _frames(JFrameGraph(JAsset.from_yaml(_GRAPH), W, H, config=dict(CONFIG)), js)
    finally:
        jax.clear_caches()
    names = [e["name"] for e in JAsset.from_yaml(_GRAPH).frame]
    fg = FrameGraph(FrameGraphAsset.from_nodes(names), W, H, dict(CONFIG), device="cpu")
    assert "hiz/mip0" in fg.initial_state()
    return ref, _frames(fg, torch_scene(js))


def test_occlusion_scene_matches_jax(occlusion_frames):
    ref, got = occlusion_frames
    assert int(ref[0]["HiZCulledCount"]) == 0 and int(ref[1]["HiZCulledCount"]) > 100
    for r, g in zip(ref, got):
        for k in ("Depth", "TriId", "HiZCulledCount"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        rel = (np.abs(g["Main"] - r["Main"]) / np.maximum(np.abs(r["Main"]), 1e-3)).max(-1)
        assert (rel <= 1e-4).mean() >= 0.999


def test_culled_frame_equals_unculled_frame(occlusion_frames):
    """The cull drops only hidden triangles: the port's frame 2 is its
    frame 1 bit for bit."""
    _, got = occlusion_frames
    for k in ("Depth", "TriId", "Main"):
        np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=k)


def test_occlusion_scene_matches_reference():
    """``scenes.occlusion_scene``, which the card's cull check renders,
    rebuilds test_hiz_culling's scene: geometry, lights and sky exactly,
    the camera within 1e-6 (float32 math in two frameworks)."""
    ref = scene_arrays(_occlusion_scene())
    got = occlusion_scene(W, H, device="cpu")
    for key, want in ref.items():
        group, _, field = key.partition(".")
        if group == "attrs_packed":
            have = got.attrs_packed
        elif group == "sky":
            have = torch.as_tensor(np.asarray(getattr(got.sky, field)))
        else:
            have = getattr(getattr(got, group), field)
        have = np.asarray(have.numpy() if torch.is_tensor(have) else have)
        if group in ("frame", "prev_frame"):
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(have, want, err_msg=key)
