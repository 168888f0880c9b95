"""Light culling, depth linearisation and the eye-adaptation pieces of the
PyTorch port against the JAX package.

Inputs are made with numpy from a seed: lights scattered over the scene,
a linear-depth field with per-tile structure, the flagship camera.

Tolerances:
- light indices and counts exact. The JAX package sorts uint32 keys, the
  port int64 keys of the same (rank, id) packing; ranks come from stable
  argsorts in both. The side-plane and distance sums use the reference's
  fused rounding (core.math3d), so the same spheres touch the same tiles;
- linearised depth and tile depth bounds exact (the same float32 ops);
- histogram exact, adapted luminance within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.kernels import histogram as j_hist
from sailor_tpu.kernels import light_culling as j_lc
from sailor_tpu.kernels import postprocess as j_pp
from sailor_tpu.kernels.lights import DIRECTIONAL, POINT, SPOT, Lights as JLights
from sailor_tpu_torch.kernels import histogram as t_hist
from sailor_tpu_torch.kernels import light_culling as t_lc
from sailor_tpu_torch.kernels import postprocess as t_pp
from sailor_tpu_torch.kernels.lights import Lights as TLights
from test_torch_scenes import jax_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 256, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _lights(n, seed):
    rng = np.random.default_rng(seed)
    types = [DIRECTIONAL] + list(rng.choice([POINT, POINT, SPOT], n - 1))
    pos = np.stack([rng.uniform(-22, 22, n), rng.uniform(0.3, 3.0, n),
                    rng.uniform(-22, 22, n)], -1)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kw = dict(types=types, positions=pos, directions=dirs,
              intensities=rng.uniform(0.3, 6, (n, 3)), attenuations=[[1, 0, 0.8]] * n,
              cutoffs=np.stack([np.full(n, 0.95), np.full(n, 0.8)], -1),
              radii=[0.0] + list(rng.uniform(1.0, 6.0, n - 1)), capacity=n + 3)
    return JLights.from_host(**kw), TLights.from_host(**kw, device="cpu")


def _depth(seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(2.0, 60.0, (H // 16, W // 16))
    field = np.kron(base, np.ones((16, 16))) + rng.uniform(0, 3.0, (H, W))
    field[rng.uniform(size=(H, W)) < 0.1] = 150.0  # background
    return field.astype(np.float32)


@pytest.mark.parametrize("n_lights,coarse,k", [(300, 256, 128), (120, 24, 16), (60, 0, 128)],
                         ids=["two_level", "two_level_overflow", "single_level"])
def test_cull_lights_matches_jax(n_lights, coarse, k):
    frame = jax_scene(W, H, 2, 2).frame
    jl, tl = _lights(n_lights, seed=n_lights)
    lin = _depth(seed=7)
    kw = dict(tiles_y=H // 16, tiles_x=W // 16, viewport=(W, H), max_per_tile=k,
              coarse_capacity=coarse)
    ji, jc = j_lc.cull_lights(jl, frame.view, frame.inv_projection, jnp.asarray(lin), **kw)
    ti, tc = t_lc.cull_lights(tl, _t(frame.view), _t(frame.inv_projection), _t(lin), **kw)
    assert int(np.asarray(jc).max()) > 1
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_linearize_depth_and_bounds_match_jax():
    rng = np.random.default_rng(2)
    d = rng.uniform(0, 1, (H, W)).astype(np.float32)
    d[rng.uniform(size=(H, W)) < 0.2] = 0.0
    znf = np.asarray([0.1, 150.0], np.float32)
    ref = np.asarray(j_pp.linearize_depth(jnp.asarray(d), znf[0], znf[1]))
    got = t_pp.linearize_depth(_t(d), _t(znf)[0], _t(znf)[1]).numpy()
    np.testing.assert_array_equal(got, ref)
    for r, g in zip(j_lc.tile_depth_bounds(jnp.asarray(ref), H // 16, W // 16),
                    t_lc.tile_depth_bounds(_t(ref), H // 16, W // 16)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_histogram_and_adaptation_match_jax():
    rng = np.random.default_rng(4)
    hdr = (rng.lognormal(-1.0, 2.0, (H // 4, W // 4, 3))).astype(np.float32)
    hdr[:4] = 0.0
    jh = np.asarray(j_hist.luminance_histogram(jnp.asarray(hdr)))
    th = t_hist.luminance_histogram(_t(hdr)).numpy()
    np.testing.assert_array_equal(th, jh)
    ja = float(j_hist.adapt_average_luminance(jnp.asarray(jh), jnp.asarray(0.18),
                                              float(hdr.shape[0] * hdr.shape[1]),
                                              jnp.asarray(1 / 60 + 0.25, jnp.float32)))
    ta = float(t_hist.adapt_average_luminance(_t(th), torch.tensor(0.18),
                                              float(hdr.shape[0] * hdr.shape[1]),
                                              torch.tensor(1 / 60 + 0.25)))
    assert abs(ta - ja) <= 1e-6 * abs(ja)
