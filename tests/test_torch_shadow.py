"""The port's ``kernels/shadow.py`` and ``kernels/blur.py`` against the JAX
package's, on the same numpy inputs.

Tolerances: ``cascade_matrices`` bit-equal to the reference's compiled
function (the rounding its frame graph gives them), which is within any
relative bar; ``select_cascade`` exact; ``evsm_warp``, ``blur_1d``,
``gaussian_blur`` and ``evsm_blur`` within 1e-6 relative (random depth,
radii 1, 4 and 8, each axis); ``csm_shadow_factor_evsm``,
``csm_shadow_factor``, ``shadow_pcf`` and ``shadow_evsm`` within 1e-3
absolute on >= 99.9% of the pixels of ``tests/test_shadow.py``'s
cube-on-plane scene (its maps and G-buffer rastered once by the port, on
the CPU, and given to both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as j_m3
from sailor_tpu.kernels import blur as j_blur
from sailor_tpu.kernels import shadow as j_shadow
from sailor_tpu_torch import config
from sailor_tpu_torch.kernels import blur, shadow
from sailor_tpu_torch.raster import pipeline
from sailor_tpu_torch.raster.setup import Geometry
from sailor_tpu_torch.scenes import flagship_scene
from test_shadow import _scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)


def _t(x):
    return torch.from_numpy(np.array(x))


def _camera(eye, target, fov, aspect, near, far):
    view = j_m3.look_at(jnp.asarray(eye), jnp.asarray(target), jnp.asarray([0.0, 1.0, 0.0]))
    return np.asarray(view), np.asarray(j_m3.perspective(fov, aspect, near, far))


def _jax_cascades(view, proj, ld, near, far):
    fn = jax.jit(lambda v, p, l: j_shadow.cascade_matrices(v, p, l, near, far))
    return np.asarray(fn(view, proj, ld))


CAMERAS = {
    "flagship": None,
    "test_shadow": (((0.0, 3.0, 8.0), (0.0, 0.0, 0.0), np.pi / 3, 16 / 9, 0.1, 100.0),
                    (-0.3, -1.0, -0.2)),
    "sun_overhead": (((0.0, 6.0, 10.0), (0.0, 0.0, 0.0), np.pi / 3, 1.0, 0.1, 50.0),
                     (0.01, -1.0, 0.01)),
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_cascade_matrices_match_jax(name):
    if name == "flagship":
        scene = flagship_scene(256, 128, 2, 2, device="cpu")
        view, proj = scene.frame.view.numpy(), scene.frame.projection.numpy()
        ld, near, far = scene.sky.sun_direction, 0.1, 150.0
    else:
        cam, ld = CAMERAS[name]
        view, proj = _camera(*cam)
        ld = np.asarray(j_m3.normalize(jnp.asarray(ld)))
        near, far = cam[4], cam[5]
    want = _jax_cascades(view, proj, ld, near, far)
    got = shadow.cascade_matrices(_t(view), _t(proj), ld, near, far).numpy()
    assert got.shape == (config.NUM_CSM_CASCADES, 4, 4)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_select_cascade_matches_jax():
    rng = np.random.default_rng(3)
    scene = flagship_scene(256, 128, 2, 2, device="cpu")
    wp = rng.uniform([-40, 0, -40], [40, 8, 40], (20000, 3)).astype(np.float32)
    want = np.asarray(j_shadow.select_cascade(jnp.asarray(scene.frame.view.numpy()),
                                              jnp.asarray(wp), 150.0))
    got = shadow.select_cascade(scene.frame.view, _t(wp), 150.0).numpy()
    assert set(np.unique(want)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(got, want)


def _rel_close(got, want, tol=1e-6):
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert err.max() <= tol, err.max()


def _moments(seed=4):
    depth = np.random.default_rng(seed).random((3, 40, 56), dtype=np.float32)
    depth[:, :, :10] = 0.0  # background texels
    return depth


def test_evsm_warp_matches_jax():
    d = _moments()
    _rel_close(shadow.evsm_warp(_t(d)).numpy(), np.asarray(j_shadow.evsm_warp(jnp.asarray(d))))


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("radius", [1, 4, 8])
def test_blur_1d_matches_jax(radius, axis):
    m = np.asarray(j_shadow.evsm_warp(jnp.asarray(_moments())))
    want = np.asarray(j_blur.blur_1d(jnp.asarray(m), radius, axis))
    _rel_close(blur.blur_1d(_t(m), radius, axis).numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("radius", [1, 4, 8])
def test_evsm_blur_matches_jax(radius, axis):
    m = np.asarray(j_shadow.evsm_warp(jnp.asarray(_moments()[0])))
    want = np.asarray(j_blur.evsm_blur(jnp.asarray(m), radius, radius // 2 + 1, axis))
    _rel_close(blur.evsm_blur(_t(m), radius, radius // 2 + 1, axis).numpy(), want)


def test_gaussian_blur_matches_jax():
    img = np.random.default_rng(5).random((30, 44, 3), dtype=np.float32)
    want = np.asarray(j_blur.gaussian_blur(jnp.asarray(img), 4))
    _rel_close(blur.gaussian_blur(_t(img), 4).numpy(), want)


S = 256  # the cube-on-plane scene's shadow maps


@pytest.fixture(scope="module")
def cube_on_plane():
    """test_shadow.py's scene and camera with a slanted sun (its sun, nearly
    overhead, hides the cube's shadow under the cube): the reference's
    cascades, the port's maps (cull none) and a 128x128 G-buffer of the
    camera."""
    jgeo = _scene()
    geo = Geometry(**{f: _t(getattr(jgeo, f)) for f in
                      ("position", "normal", "uv", "color", "indices", "material_id")})
    ld = np.asarray(j_m3.normalize(jnp.asarray([0.6, -1.0, 0.4])))
    view, proj = _camera((0.0, 6.0, 10.0), (0.0, 0.0, 0.0), np.pi / 3, 1.0, 0.1, 50.0)
    mats = _jax_cascades(view, proj, ld, 0.1, 50.0)
    maps = np.stack([pipeline.rasterize(geo, _t(mats[c]), width=S, height=S, capacity=512,
                                        rounds=2, cull="none", device="cpu")[1].numpy()
                     for c in range(config.NUM_CSM_CASCADES)])
    gb = pipeline.rasterize(geo, _t(proj @ view), width=128, height=128, capacity=512,
                            rounds=2, device="cpu")[0]
    moments = blur.blur_1d(blur.blur_1d(shadow.evsm_warp(_t(maps)), 4, 1), 4, 2).numpy()
    return dict(view=view, ld=ld, mats=mats, maps=maps, moments=moments,
                wpos=gb.world_position.numpy(), normal=gb.normal.numpy(),
                coverage=gb.coverage.numpy())


def _factor_close(got, want):
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-3).mean() >= 0.999


def _both(d, fn_name, *keys, **kw):
    want = np.asarray(getattr(j_shadow, fn_name)(*(jnp.asarray(d[k]) for k in keys), **kw))
    got = getattr(shadow, fn_name)(*(_t(d[k]) for k in keys), **kw).numpy()
    return got, want


def test_csm_shadow_factor_evsm_matches_jax(cube_on_plane):
    d = cube_on_plane
    got, want = _both(d, "csm_shadow_factor_evsm", "wpos", "normal", "view", "ld", "mats",
                      "moments", z_far=50.0)
    lit = want[d["coverage"] > 0]
    assert (lit < 0.3).mean() > 0.01 and (lit > 0.8).mean() > 0.5  # shadow and light
    _factor_close(got, want)


@pytest.mark.parametrize("use_evsm", [True, False])
def test_csm_shadow_factor_matches_jax(cube_on_plane, use_evsm):
    d = dict(cube_on_plane, evsm0=cube_on_plane["moments"][0])
    got, want = _both(d, "csm_shadow_factor", "wpos", "normal", "view", "ld", "mats", "maps",
                      "evsm0", z_far=50.0, use_evsm=use_evsm)
    assert (want[d["coverage"] > 0] < 0.3).mean() > 0.01
    _factor_close(got, want)


def test_single_cascade_lookups_match_jax(cube_on_plane):
    """shadow_pcf, shadow_evsm and the stacked PCF on cascade 1."""
    d = dict(cube_on_plane, mat1=cube_on_plane["mats"][1], map1=cube_on_plane["maps"][1],
             ev1=cube_on_plane["moments"][1], flat=cube_on_plane["maps"].reshape(-1))
    _factor_close(*_both(d, "shadow_pcf", "map1", "mat1", "wpos", "normal", "ld"))
    _factor_close(*_both(d, "shadow_evsm", "ev1", "mat1", "wpos"))
    want = np.asarray(j_shadow._pcf_stacked(jnp.asarray(d["flat"]), S, 1, jnp.asarray(d["mat1"]),
                                            jnp.asarray(d["wpos"]), jnp.asarray(d["normal"]),
                                            jnp.asarray(d["ld"])))
    got = shadow._pcf_stacked(_t(d["flat"]), S, 1, _t(d["mat1"]), _t(d["wpos"]),
                              _t(d["normal"]), d["ld"]).numpy()
    _factor_close(got, want)
