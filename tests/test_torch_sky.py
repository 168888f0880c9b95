"""The port's noise and procedural sky against the JAX package's, on the CPU.

- ``core/noise``: ``_hash3`` bit for bit on lattice points of both signs
  (int32 products wrap and ``>>`` is arithmetic in both packages), and
  ``value_noise3``/``fbm3`` exactly equal to the reference's eager
  functions (its jitted FBM differs by ~2e-7, where XLA fuses);
- ``kernels/sky``: ``SkyParams.default`` equal; ``atmosphere``, ``clouds``
  and ``sky_radiance`` with and without the sun on the 16x32 lat-long grid
  of the tracer's bake within 5e-5 * (1 + |ref|) (the reference is jitted:
  XLA fuses products into adds and evaluates exp and pow its own way, and
  the atmosphere integrates exp of optical depths over 16 x 4 steps;
  measured 2.1e-5); the phase functions within 1e-6;
- the path tracer's env bake (``scene_from_mesh(sky=...)``) at 16x32 at the
  same bound, and its miss-ray lookup (``sky_radiance`` of the scene) on
  the reference's bake within 5e-6 * (1 + |ref|) for directions over the
  sphere, poles, seam and texel centres included (atan2 and acos differ
  by an ulp between the packages, which moves the bilinear weights;
  measured 1.1e-6);
- stars under the night sun on the same grid (the reference's
  ``procedural(1024)`` field) within the sky's bound plus 2e-3 of the star
  term (test_torch_stars.py's bar), lighting >= 4 grid directions;
  ``cloud_stride`` 2 on a 2-D ray grid (clouds marched on every other ray
  and upsampled) matches the reference at the sky's bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import primitives as jax_primitives
from sailor_tpu.core import noise as jax_noise
from sailor_tpu.kernels import sky as jax_sky
from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu_torch.core import noise
from sailor_tpu_torch.kernels import sky
from sailor_tpu_torch.raytracing import path_tracer as pt
from test_torch_path_tracer import _carry
from test_torch_scenes import release_jax_executables  # noqa: F401

SKY_TOL = 5e-5


def test_hash_and_noise_exact():
    rng = np.random.default_rng(0)
    lat = rng.integers(-40000, 40000, (50000, 3)).astype(np.float32)
    assert (lat < 0).any(1).mean() > 0.8
    np.testing.assert_array_equal(noise._hash3(torch.from_numpy(lat)).numpy(),
                                  np.asarray(jax_noise._hash3(jnp.asarray(lat))))
    p = rng.uniform(-500, 500, (20000, 3)).astype(np.float32)
    for name, kw in (("value_noise3", {}), ("fbm3", {}), ("fbm3", {"octaves": 3})):
        want = np.asarray(getattr(jax_noise, name)(jnp.asarray(p), **kw))
        got = getattr(noise, name)(torch.from_numpy(p), **kw).numpy()
        np.testing.assert_array_equal(got, want, name)


def _grid(he=16, we=32):
    """The tracer's lat-long bake directions (``scene_from_mesh``)."""
    th = (np.arange(he, dtype=np.float32) + 0.5) / he * np.pi
    ph = (np.arange(we, dtype=np.float32) + 0.5) / we * 2.0 * np.pi - np.pi
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    return np.stack([np.broadcast_to(st * np.cos(ph)[None, :], (he, we)),
                     np.broadcast_to(ct, (he, we)),
                     np.broadcast_to(st * np.sin(ph)[None, :], (he, we))], -1).astype(np.float32)


def _close(got, want, tol=SKY_TOL):
    want = np.asarray(want)
    assert np.isfinite(want).all() and got.shape == want.shape
    err = np.abs(got - want) / (1 + np.abs(want))
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("params", [{}, {"sun_direction": (0.2, -0.3, 0.6),
                                         "clouds_coverage": 0.6}], ids=["default", "low_sun"])
def test_sky_matches_reference(params):
    jp, tp = jax_sky.SkyParams.default(**params), sky.SkyParams.default(**params)
    for f in ("sun_direction", "sun_intensity", "clouds_coverage", "eccentricity2", "ambient"):
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)))
    d = _grid()
    dj, dt = jnp.asarray(d), torch.from_numpy(d)
    want = jax_sky.atmosphere(dj, jnp.asarray(jp.sun_direction), jp.sun_intensity)
    got = sky.atmosphere(dt, torch.from_numpy(tp.sun_direction), torch.tensor(tp.sun_intensity))
    for a, b in zip(want, got):
        _close(b.numpy(), a)
    for a, b in zip(jax_sky.clouds(dj, jp), sky.clouds(dt, tp)):
        _close(b.numpy(), a)
    for with_sun in (False, True):
        _close(sky.sky_radiance(dt, tp, with_sun=with_sun).numpy(),
               jax_sky.sky_radiance(dj, jp, with_sun=with_sun, cloud_stride=1))
    c = np.linspace(-1, 1, 1001, dtype=np.float32)
    _close(sky.phase_rayleigh(torch.from_numpy(c)).numpy(),
           jax_sky.phase_rayleigh(jnp.asarray(c)), 1e-6)
    for g in (0.76, -0.2):
        _close(sky.phase_hg(torch.from_numpy(c), g).numpy(), jax_sky.phase_hg(jnp.asarray(c), g),
               1e-6)


def test_env_bake_and_lookup_match_reference():
    soup = jax_primitives.merge([(jax_primitives.plane(1.0), np.eye(4))], material_ids=[0])
    ref = jax_pt.scene_from_mesh(soup, sky=jax_sky.SkyParams.default(), env_size=(16, 32))
    got = pt.scene_from_mesh(soup, sky=sky.SkyParams.default(), env_size=(16, 32), device="cpu")
    _close(got.env_map.numpy(), ref.env_map)
    scene = _carry(ref)
    rng = np.random.default_rng(1)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d = np.concatenate([d, _grid().reshape(-1, 3),
                        [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -1e-7], [-1, 0, 1e-7]]])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    for include_sun in (False, True):
        want = np.asarray(jax_pt.sky_radiance(ref, jnp.asarray(d), include_sun=include_sun))
        have = pt.sky_radiance(scene, torch.from_numpy(d), include_sun=include_sun).numpy()
        _close(have, want, 5e-6)


def test_stars_and_cloud_stride_raise():
    """Once the refusal of stars; now the stars' parity on the grid, and
    ``cloud_stride``'s."""
    from sailor_tpu.assets import stars as jax_stars
    from test_torch_stars import NIGHT_SUN, star_bar

    sd, sc = jax_stars.procedural(1024, seed=2)
    d = _grid()
    want = np.asarray(jax_sky.sky_radiance(jnp.asarray(d), jax_sky.SkyParams.default(
        sun_direction=NIGHT_SUN), 1.0, jnp.asarray(sd), jnp.asarray(sc), with_stars=True))
    p = sky.SkyParams.default(sun_direction=NIGHT_SUN)
    got = sky.sky_radiance(torch.from_numpy(d), p, 1.0, torch.from_numpy(sd),
                           torch.from_numpy(sc), with_stars=True).numpy()
    term = got - sky.sky_radiance(torch.from_numpy(d), p, 1.0).numpy()
    assert (np.abs(term).max(-1) > 1e-6).sum() >= 4
    assert np.all(np.abs(got - want) <= star_bar(want, term))
    g = _grid()
    _close(sky.sky_radiance(torch.from_numpy(g), sky.SkyParams.default(), 3.0,
                            cloud_stride=2).numpy(),
           jax_sky.sky_radiance(jnp.asarray(g), jax_sky.SkyParams.default(), 3.0,
                                cloud_stride=2))
