"""The port's star field against the JAX package's, on the CPU.

- ``assets.stars``: ``blackbody_rgb`` over 1000-40000 K and the clip
  ranges, ``procedural`` and ``load`` of a .bsc5 file the test writes (more
  entries than ``max_stars``, a truncated last entry, unknown spectral
  letters) bit-equal: the same numpy code; the registry's .bsc5 importer
  returns the same arrays;
- ``sky.stars`` on 40,000 directions (half of them within ~0.6 degrees of a
  star) against the reference's compiled function: within
  1e-4 * |ref| + 1e-7 per channel (measured 3.6e-7 relative), the term
  nonzero on >= 30,000 of them; the same in 7-row chunks;
- ``sky_radiance(with_stars=True)`` under the night sun (-0.35, 0.7, -0.3),
  whose night factor is 1: within the sky's 5e-5 * (1 + |ref|) plus the
  star bar below, the stars lighting >= 1,000 of 2,048 grid directions; with
  the default (day) sun the stars add nothing, as the night factor is 0;
- the star bar of a frame: a unit in the last place of cos near 1 moves a
  star's weight by 8000 * 6e-8 = 4.8e-4 relative, and the reference's
  compiled frame normalises the rays by an rsqrt estimate (ROADMAP C 1), so
  a frame's star term differs from the reference's by up to 1.4e-3 of
  itself (measured on the Sky node of test_torch_debug_draw.py's night
  loop); a frame's Sky is held to 5e-5 * (1 + |ref|) + 2e-3 * |star term|.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import stars as jax_stars
from sailor_tpu.kernels import sky as jax_sky
from sailor_tpu_torch.assets import stars
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.kernels import sky
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

NIGHT_SUN = (-0.35, 0.7, -0.3)
STAR_REL = 2e-3  # a frame's star term against the reference's (see above)


def star_bar(ref, star_term):
    """The Sky bar of a night frame: the sky's 5e-5 * (1 + |ref|) plus
    STAR_REL of the port's star term at the pixel."""
    return 5e-5 * (1 + np.abs(ref)) + STAR_REL * np.abs(star_term)


def test_blackbody_rgb_bit_equal():
    temps = np.concatenate([np.linspace(1000, 40000, 997), [500.0, 66e2, 19e2, 6e4]])
    np.testing.assert_array_equal(stars.blackbody_rgb(temps), jax_stars.blackbody_rgb(temps))
    for t in stars.MK_TEMPERATURE.values():
        np.testing.assert_array_equal(stars.blackbody_rgb(t), jax_stars.blackbody_rgb(t))


@pytest.mark.parametrize("n,seed", [(2048, 0), (4096, 0), (300, 7)])
def test_procedural_bit_equal(n, seed):
    got, want = stars.procedural(n, seed=seed), jax_stars.procedural(n, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (n, 3)
        np.testing.assert_array_equal(g, w)


def write_bsc5(path, n, seed=0, truncate=True):
    """A BSC5 binary catalogue: the 28-byte header, then 32-byte entries
    (xno f32, ra f64, dec f64, spectral 2 bytes, magnitude x100 i16, two
    f32 proper motions); the last entry cut short when ``truncate``."""
    rng = np.random.default_rng(seed)
    data = bytearray(struct.pack("<7i", 1, 1, -n, 0, 1, 1, 32))
    letters = b"OBAFGKMWX?"
    for i in range(n):
        spec = bytes([letters[rng.integers(len(letters))], 0x30 + rng.integers(10)])
        data += struct.pack("<f2d", float(i + 1), rng.uniform(0, 2 * np.pi),
                            rng.uniform(-np.pi / 2, np.pi / 2))
        data += spec + struct.pack("<h", int(rng.integers(-150, 800)))
        data += struct.pack("<2f", 0.0, 0.0)
    if truncate:
        data = data[:-5]
    path.write_bytes(bytes(data))
    return str(path)


@pytest.mark.parametrize("n,max_stars", [(50, 4096), (300, 128)])
def test_load_bsc5_bit_equal(tmp_path, n, max_stars):
    path = write_bsc5(tmp_path / "catalog.bsc5", n)
    got = stars.load(path, max_stars=max_stars)
    want = jax_stars.load(path, max_stars=max_stars)
    assert got[0].shape == (min(n - 1, max_stars), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_registry_imports_bsc5(tmp_path):
    path = write_bsc5(tmp_path / "stars.bsc5", 40, seed=3)
    reg = AssetRegistry(str(tmp_path))
    assert reg.scan_content_folder() == 1
    got = reg.load(path)
    for g, w in zip(got, jax_stars.load(path)):
        np.testing.assert_array_equal(g, w)


def _near_star_directions(dirs, n=20000, seed=3):
    """n directions within ~0.01 rad of catalogue stars and n uniform ones,
    all in the upper hemisphere."""
    rng = np.random.default_rng(seed)
    near = dirs[rng.integers(0, len(dirs), n)] + rng.normal(scale=0.01, size=(n, 3))
    d = np.concatenate([near, rng.normal(size=(n, 3))]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 1] = np.abs(d[:, 1])
    return d


@pytest.mark.parametrize("chunk", [sky.STAR_CHUNK, 7])
def test_stars_match_reference(chunk):
    sd, sc = jax_stars.procedural(4096, seed=0)
    d = _near_star_directions(sd)
    tr = np.random.default_rng(4).uniform(0.2, 1.0, d.shape).astype(np.float32)
    n = 40000 if chunk == sky.STAR_CHUNK else 700
    want = np.asarray(jax.jit(jax_sky.stars)(d[:n], sd, sc, tr[:n]))
    got = sky.stars(*(torch.from_numpy(a) for a in (d[:n], sd, sc, tr[:n])), chunk=chunk).numpy()
    assert (np.abs(want).max(-1) > 1e-6).sum() >= 0.75 * n
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-7)


def _grid(h=32, w=64):
    """Directions over the upper hemisphere, (h, w, 3)."""
    az, el = np.meshgrid(np.linspace(0, 2 * np.pi, w), np.linspace(0.02, 1.5, h))
    return np.stack([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)],
                    -1).astype(np.float32)


def test_sky_radiance_with_stars_matches_reference():
    sd, sc = jax_stars.procedural(4096, seed=0)
    d = np.concatenate([_near_star_directions(sd, 1024).reshape(32, 64, 3), _grid()])
    jp = jax_sky.SkyParams.default(sun_direction=NIGHT_SUN)
    p = sky.SkyParams.default(sun_direction=NIGHT_SUN)
    want = np.asarray(jax_sky.sky_radiance(jnp.asarray(d), jp, 2.0, jnp.asarray(sd),
                                           jnp.asarray(sc), with_stars=True, cloud_stride=2))
    args = (torch.from_numpy(d), p, 2.0)
    got = sky.sky_radiance(*args, torch.from_numpy(sd), torch.from_numpy(sc),
                           with_stars=True, cloud_stride=2).numpy()
    bare = sky.sky_radiance(*args, cloud_stride=2).numpy()
    star = got - bare
    assert (np.abs(star).max(-1) > 1e-6).sum() >= 1000
    assert np.all(np.abs(got - want) <= star_bar(want, star))


def test_day_sun_hides_the_stars():
    sd, sc = (torch.from_numpy(a) for a in stars.procedural(512, seed=1))
    d = torch.from_numpy(_grid(8, 16))
    p = sky.SkyParams.default()
    assert p.sun_direction[1] < 0
    np.testing.assert_array_equal(
        sky.sky_radiance(d, p, star_dirs=sd, star_colors=sc, with_stars=True).numpy(),
        sky.sky_radiance(d, p).numpy())
