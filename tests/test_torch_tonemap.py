"""The port's tone mapping against the JAX package's, on the CPU.

- ``math3d.rgb_to_yxy``/``yxy_to_rgb`` on 4,096 HDR colours (zeros and
  near-black included): within 1e-6 * (1 + |ref|), and the round trip
  within 1e-4 of the colour's largest channel;
- ``tonemap`` in each mode (aces, uncharted2, reinhard, none), on RGB and
  with ``luminance_only``, with the default and a custom white point and
  exposure: within 2e-6 * (1 + |ref|) (the 3x3 products are float32
  matrix products in both packages, summed in different orders);
- an unknown mode raises ValueError in both packages, and the frame graph
  refuses it when it is built;
- EyeAdaptation in each mode: the minimal graph's frame at 128x96 renders
  Final within 2/255 of the reference's (test_torch_frame.py's bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.kernels import tonemap as jax_tm
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels import tonemap as tm
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG, release_jax_executables  # noqa: F401


def _colors(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.lognormal(-1.0, 2.0, (n, 3)).astype(np.float32)
    c[:16] = 0.0
    c[16:32] = rng.uniform(0, 1e-7, (16, 3))
    c[32:48, 1:] = 0.0
    return c


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1 + np.abs(want))
    assert err.max() <= tol, err.max()


def test_yxy_conversions_match_reference():
    c = _colors()
    yxy = m3.rgb_to_yxy(torch.from_numpy(c))
    _close(yxy.numpy(), jax_m3.rgb_to_yxy(jnp.asarray(c)), 1e-6)
    back = m3.yxy_to_rgb(yxy).numpy()
    _close(back, jax_m3.yxy_to_rgb(jnp.asarray(yxy.numpy())), 1e-6)
    lit = c.sum(-1) > 1e-3
    assert np.all(np.abs(back[lit] - c[lit]) <= 1e-4 * c[lit].max(-1, keepdims=True))


@pytest.mark.parametrize("luminance_only", [False, True], ids=["rgb", "luminance"])
@pytest.mark.parametrize("mode", tm.MODES)
def test_tonemap_matches_reference(mode, luminance_only):
    c = _colors(seed=1).reshape(64, 64, 3)
    for kw in ({}, {"white_point": (6.0, 5.0, 4.0), "exposure": 1.7}):
        for avg in (0.18, 2.5):
            want = jax_tm.tonemap(jnp.asarray(c), jnp.float32(avg), mode=mode,
                                  luminance_only=luminance_only, **kw)
            got = tm.tonemap(torch.from_numpy(c), torch.tensor(avg, dtype=torch.float32),
                             mode=mode, luminance_only=luminance_only, **kw)
            _close(got.numpy(), want, 2e-6)


def test_unknown_mode_raises():
    c = jnp.ones((4, 3))
    with pytest.raises(ValueError, match="unknown tonemap mode"):
        jax_tm.tonemap(c, 0.18, mode="filmic")
    with pytest.raises(ValueError, match="unknown tonemap mode"):
        tm.tonemap(torch.ones(4, 3), torch.tensor(0.18), mode="filmic")
    with pytest.raises(ValueError, match="unknown tonemap mode"):
        FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 64, 64,
                   dict(SLICE_CONFIG, tonemap="filmic"), device="cpu")


@pytest.mark.parametrize("mode", tm.MODES)
def test_eye_adaptation_modes_match_reference(mode):
    from sailor_tpu.framegraph import FrameGraph as JFrameGraph
    from sailor_tpu.framegraph import FrameGraphAsset as JFrameGraphAsset
    from sailor_tpu_torch.rhi.scene_view import scene_from_numpy
    from test_torch_scenes import jax_scene, scene_arrays

    config = dict(SLICE_CONFIG, tonemap=mode, pallas_shading=False)
    js = jax_scene(128, 96, 8, 4)
    yaml_text = "frame:\n" + "".join(f" - name: {n}\n" for n in MINIMAL_GRAPH)
    jfg = JFrameGraph(JFrameGraphAsset.from_yaml(yaml_text), 128, 96, config)
    want, _ = jfg.process(js, jfg.initial_state())
    fg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), 128, 96, config, device="cpu")
    got, _ = fg.process(scene_from_numpy(scene_arrays(js), "cpu"), fg.initial_state())
    np.testing.assert_array_equal(got["TriId"].numpy(), np.asarray(want["TriId"]))
    assert np.abs(got["Final"].numpy() - np.asarray(want["Final"])).max() <= 2 / 255
