"""The port's post passes and bloom against the JAX package's, on the CPU,
with the same numpy inputs.

Tolerances (relative to max(|ref|, 1e-3) unless stated):
- ``hbao``: the reference's function run op by op (``jax.disable_jit``)
  within 1e-6 * (1 + |ref|) everywhere (measured 3.3e-7); its compiled
  function within 1e-5 at every pixel more than 16 from the border
  (measured 2.2e-7) and on >= 99.5% of all pixels (measured 99.76% and
  99.82%). The compiled reference fuses a product into each tap's
  difference, so where a tap clamps at the border the difference is a
  rounding error, not 0, and the horizon sine (divided by at most 1e-6)
  turns it into occlusion at a few border pixels (15 and 11 of 6144 here);
- ``motion_blur`` with a moved previous camera, ``sun_shafts`` (sun on and
  off screen), ``chromatic_aberration``, ``downsample_quarter``,
  ``_sample_shift`` and ``bloom`` with lens dirt within 1e-5 (measured
  1.7e-7, 4.5e-7, 1.6e-6, 0, below 1e-5 and 0); ``lens_dirt`` exact;
- the port's counterparts of the bloom and sampler tests of
  tests/test_post_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.kernels import bloom as jax_bloom
from sailor_tpu.kernels import postprocess as jax_pp
from sailor_tpu_torch.kernels import bloom, postprocess as pp, sampling
from test_torch_scenes import release_jax_executables  # noqa: F401

H, W = 64, 96
# the flagship camera's inverse projection (60 degrees, 0.1-150)
INV_PROJ = np.array([[0.8660255, 0, 0, 0], [0, 0.5773503, 0, 0], [0, 0, 0, -1],
                     [0, 0, 9.993333, 0.006666666]], np.float32)
VIEW_PROJ = np.array([[1.1547, 0, -0.3, 0.2], [0.1, 1.6, 0.2, -1.0], [0, 0, 0.0007, 0.1],
                      [0.3, -0.2, -0.93, 12.0]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-3)


def _depths():
    rng = np.random.default_rng(0)
    noisy = rng.uniform(1, 20, (H, W)).astype(np.float32)
    noisy[20:40, 30:60] = 3.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = (5 + 0.05 * xx + 0.1 * yy).astype(np.float32)
    smooth[20:40, 30:60] -= 1.5
    return {"noisy": noisy, "smooth": smooth}


@pytest.mark.parametrize("kind", ["noisy", "smooth"])
def test_hbao_matches_reference(kind):
    ld = _depths()[kind]
    kw = dict(height=H, width=W, radius=0.6, power=1.6)
    got = pp.hbao(_t(ld), _t(INV_PROJ), **kw).numpy()
    with jax.disable_jit():
        eager = np.asarray(jax_pp.hbao(jnp.asarray(ld), jnp.asarray(INV_PROJ), **kw))
    assert (np.abs(got - eager) / (1 + np.abs(eager))).max() <= 1e-6
    rel = _rel(got, jax_pp.hbao(jnp.asarray(ld), jnp.asarray(INV_PROJ), **kw))
    assert rel[16:-16, 16:-16].max() <= 1e-5
    assert (rel <= 1e-5).mean() >= 0.995
    assert 0.3 < got.mean() < 1.0


def _color(seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 4, (H, W, 3)).astype(np.float32)


def test_motion_blur_matches_reference():
    col = _color()
    dep = np.random.default_rng(2).uniform(0, 1, (H, W)).astype(np.float32)
    dep[:10] = 0.0  # background
    inv = np.linalg.inv(VIEW_PROJ).astype(np.float32)
    prev = VIEW_PROJ.copy()
    prev[0, 3] += 0.3  # the camera moved since the previous frame
    kw = dict(intensity=0.5, num_samples=4)
    got = pp.motion_blur(_t(col), _t(dep), _t(prev), _t(inv), **kw).numpy()
    want = jax_pp.motion_blur(jnp.asarray(col), jnp.asarray(dep), jnp.asarray(prev),
                              jnp.asarray(inv), **kw)
    assert _rel(got, want).max() <= 1e-5
    assert np.abs(got - (col + 3 * col) / 4).max() > 1e-3  # the blur moved something


@pytest.mark.parametrize("sun", [(-0.3, -0.4, -0.5), (0.3, -0.2, 0.9), (0.0, 0.6, -0.8)],
                         ids=["default", "on_screen", "below"])
def test_sun_shafts_match_reference(sun):
    col = _color()
    dep = np.random.default_rng(3).uniform(0, 1, (H, W)).astype(np.float32)
    dep[:, :40] = 0.0
    sd = np.asarray(sun, np.float32) / np.linalg.norm(sun)
    tint = np.float32(20.0) * np.asarray([1.0, 0.9, 0.75], np.float32)
    kw = dict(intensity=0.45, num_samples=24)
    got = pp.sun_shafts(_t(col), _t(dep), _t(VIEW_PROJ), _t(sd), _t(tint), **kw).numpy()
    want = jax_pp.sun_shafts(jnp.asarray(col), jnp.asarray(dep), jnp.asarray(VIEW_PROJ),
                             jnp.asarray(sd), jnp.asarray(tint), **kw)
    assert _rel(got, want).max() <= 1e-5


def test_screen_samplers_match_reference():
    """chromatic_aberration, downsample_quarter and _sample_shift (per-pixel
    offsets, past the edges too)."""
    col = _color(4)
    got = pp.chromatic_aberration(_t(col), 0.003).numpy()
    assert _rel(got, jax_pp.chromatic_aberration(jnp.asarray(col), 0.003)).max() <= 1e-5
    assert _rel(pp.downsample_quarter(_t(col)).numpy(),
                jax_pp.downsample_quarter(jnp.asarray(col))).max() <= 1e-5
    rng = np.random.default_rng(7)
    du, dv = (rng.uniform(-3, 3, (H, W)).astype(np.float32) for _ in range(2))
    got = pp._sample_shift(_t(col), _t(du), _t(dv), H, W).numpy()
    want = jax_pp._sample_shift(jnp.asarray(col), jnp.asarray(du), jnp.asarray(dv), H, W)
    assert _rel(got, want).max() <= 1e-5


def test_bloom_and_lens_dirt_match_reference():
    np.testing.assert_array_equal(bloom.lens_dirt(H, W), jax_bloom.lens_dirt(H, W))
    col = _color(5) * 2.0
    dirt = bloom.lens_dirt(H, W)
    kw = dict(threshold=1.0, knee=0.5, intensity=0.35, dirt_intensity=0.6)
    got = bloom.bloom(_t(col), dirt=_t(dirt), **kw).numpy()
    want = jax_bloom.bloom(jnp.asarray(col), dirt=dirt, **kw)
    assert _rel(got, want).max() <= 1e-5
    odd = col[:61, :93]  # odd sizes pad the upsampled mips with their edge
    assert _rel(bloom.bloom(_t(odd)).numpy(), jax_bloom.bloom(jnp.asarray(odd))).max() <= 1e-5


# --- counterparts of tests/test_post_kernels.py ----------------------------


def test_bloom_threshold_kills_dark():
    assert float(bloom.bloom(torch.full((64, 64, 3), 0.1), threshold=1.0, knee=0.1).max()) < 0.01


def test_bloom_bright_spot_spreads():
    img = torch.zeros(64, 64, 3)
    img[32, 32] = 50.0
    out = bloom.bloom(img, threshold=1.0)
    assert float(out[32, 32].max()) > 0 and float(out[40, 40].max()) > 0
    assert float(out.min()) >= 0


def test_downsample_13tap_constant():
    out = bloom.downsample_13tap(torch.full((32, 32, 3), 2.0))
    assert tuple(out.shape) == (16, 16, 3) and bool(torch.allclose(out, out[0, 0]))


def test_bilinear_matches_nearest_at_centers():
    img = _t(_color(6)[:16, :16])
    c = (torch.arange(16, dtype=torch.float32) + 0.5) / 16
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    out = sampling.sample_bilinear(img, torch.stack([xs, ys], -1))
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-5)


def test_wrap_modes():
    img = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    uv = torch.tensor([[1.1, 0.1]])
    assert float(sampling.sample_nearest(img, uv, wrap="repeat")[0]) == 0.0
    assert float(sampling.sample_nearest(img, uv, wrap="clamp")[0]) == 3.0
