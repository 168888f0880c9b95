"""The port's cubemaps, IBL bakes and ambient term against the JAX package's,
on the CPU, with the reference's own inputs.

- ``kernels/cubemap``: face ids exact; ``face_directions``, the face
  (u, v), ``sample_cubemap`` and ``sample_cubemap_lod_stack`` within
  1e-6 * (1 + |ref|) (measured: 0 on the face math, 0 on the samplers);
- ``kernels/ibl`` bakes on the reference's environment cube (the
  default sky at 16 and 32 texels a face): ``irradiance_map``, the four
  prefiltered mips, ``brdf_lut`` and ``sh9_project`` within 1e-5 relative
  (measured 0, 3.0e-7, 6.2e-7 and 5.2e-6). The bakes sum their samples one
  after another, as the reference's scan; the sample directions equal
  the reference's bit for bit (its compiled to_world, GGX and reflect
  roundings, and the C library's cosf/sinf it calls), so no texel lookup
  flips a face;
- the environment cube rendered from the sky within 5e-5 * (1 + |ref|)
  (the sky's bar, test_torch_sky.py);
- ``ambient_ibl_packed`` (SH9 and irradiance-cube diffuse) and
  ``ambient_ibl`` on the reference's bake within 1e-5 relative on >= 99.9%
  of pixels;
- the port's counterparts of tests/test_ibl.py, and the new samplers
  (``sample_bilinear`` with its wraps, ``blit``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.kernels import cubemap as jax_cm
from sailor_tpu.kernels import ibl as jax_ibl
from sailor_tpu.kernels import sampling as jax_sampling
from sailor_tpu.kernels import sky as jax_sky
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.kernels import cubemap as cm
from sailor_tpu_torch.kernels import ibl, sampling, sky
from test_torch_scenes import release_jax_executables  # noqa: F401

BAKE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want, floor=1e-30):
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    return (np.abs(got - want) / np.maximum(np.abs(want), floor)).max()


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err <= tol, err


def _dirs(n, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d = np.concatenate([d, [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0, 0, -1]]])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=[16, 32], ids=["r16", "r32"])
def env(request):
    """The reference's environment bake of the default sky (no clouds)."""
    p = jax_sky.SkyParams.default()
    return np.asarray(jax_cm.render_cubemap(
        lambda d: jax_sky.sky_radiance(d, p, 0.0, with_clouds=False), request.param))


def test_face_math_matches_reference():
    for r in (4, 16, 33):
        _close(cm.face_directions(r, "cpu").numpy(), jax_cm.face_directions(r), 1e-6)
    d = _dirs(20000)
    face, u, v = cm.direction_to_face_uv(_t(d))
    jf, ju, jv = jax_cm.direction_to_face_uv(jnp.asarray(d))
    np.testing.assert_array_equal(face.numpy(), np.asarray(jf))
    _close(u.numpy(), ju, 1e-6)
    _close(v.numpy(), jv, 1e-6)


def test_samplers_match_reference(env):
    d = _dirs(20000, 1)
    _close(cm.sample_cubemap(_t(env), _t(d)).numpy(),
           jax_cm.sample_cubemap(jnp.asarray(env), jnp.asarray(d)), 1e-6)
    stack = np.stack([env, env * 0.5, env * 0.25])
    lod = np.random.default_rng(2).uniform(-0.5, 2.5, len(d)).astype(np.float32)
    _close(cm.sample_cubemap_lod_stack(_t(stack), _t(d), _t(lod)).numpy(),
           jax_cm.sample_cubemap_lod_stack(jnp.asarray(stack), jnp.asarray(d),
                                           jnp.asarray(lod)), 1e-6)
    mips = [env, env[:, ::2, ::2] * 0.5]
    _close(cm.sample_cubemap_lod([_t(m) for m in mips], _t(d), _t(lod)).numpy(),
           jax_cm.sample_cubemap_lod([jnp.asarray(m) for m in mips], jnp.asarray(d),
                                     jnp.asarray(lod)), 1e-6)
    _close(cm.upsample_cubemap(_t(env[:, ::2, ::2]), env.shape[1]).numpy(),
           jax_cm.upsample_cubemap(jnp.asarray(env[:, ::2, ::2]), env.shape[1]), 1e-6)
    _close(cm.downsample_cubemap(_t(env)).numpy(), jax_cm.downsample_cubemap(jnp.asarray(env)),
           1e-6)


def test_bakes_match_reference(env):
    e, je = _t(env), jnp.asarray(env)
    assert _rel(ibl.irradiance_map(e, 16, 128).numpy(),
                jax_ibl.irradiance_map(je, 16, 128)) <= BAKE_TOL
    for got, want in zip(ibl.prefiltered_env_mips(e, 4, 32),
                         jax_ibl.prefiltered_env_mips(je, 4, 32)):
        assert _rel(got.numpy(), want) <= BAKE_TOL
    assert _rel(ibl.sh9_project(e).numpy(), jax_ibl.sh9_project(je)) <= BAKE_TOL


def test_brdf_lut_matches_reference():
    assert _rel(ibl.brdf_lut(64, 128, "cpu").numpy(), jax_ibl.brdf_lut(64, 128)) <= BAKE_TOL
    assert _rel(ibl.brdf_lut(16, 32, "cpu").numpy(), jax_ibl.brdf_lut(16, 32)) <= BAKE_TOL


@pytest.mark.parametrize("sun", [(-0.3, -0.4, -0.5), (0.6, -0.6, 0.1)], ids=["default", "moved"])
def test_env_cube_from_sky_matches_reference(sun):
    jp, tp = jax_sky.SkyParams.default(sun_direction=sun), sky.SkyParams.default(sun_direction=sun)
    want = jax_cm.render_cubemap(lambda d: jax_sky.sky_radiance(d, jp, 0.0, with_clouds=False),
                                 16)
    got = cm.render_cubemap(lambda d: sky.sky_radiance(d, tp, 0.0, with_clouds=False), 16,
                            "cpu")
    _close(got.numpy(), want, 5e-5)


def _surface(h=48, w=64, seed=3):
    rng = np.random.default_rng(seed)

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return (rng.uniform(0, 1, (h, w, 4)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32),
            rng.uniform(0.05, 1, (h, w)).astype(np.float32),
            rng.uniform(0.3, 1, (h, w)).astype(np.float32),
            unit((h, w, 3)), unit((h, w, 3)))


def _ambient_share(got, want):
    want = np.asarray(want)
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-3)).max(-1)
    return (rel <= 1e-5).mean()


def test_ambient_matches_reference(env):
    je = jnp.asarray(env)
    irr = jax_ibl.irradiance_map(je, 16, 64)
    mips = jax_ibl.prefiltered_env_mips(je, 4, 16)
    stack = jnp.stack([jax_cm.upsample_cubemap(m, env.shape[1]) for m in mips])
    sh = jax_ibl.sh9_project(je)
    lut = jax_ibl.brdf_lut(32, 64)
    args = _surface()
    jargs, targs = [jnp.asarray(a) for a in args], [_t(a) for a in args]
    for sh_j, sh_t in ((sh, _t(sh)), (None, None)):
        want = jax_ibl.ambient_ibl_packed(*jargs, irr, stack, irradiance_sh=sh_j)
        got = ibl.ambient_ibl_packed(*targs, _t(irr), _t(stack), irradiance_sh=sh_t)
        assert _ambient_share(got.numpy(), want) >= 0.999
    want = jax_ibl.ambient_ibl(*jargs, irr, list(mips), lut)
    got = ibl.ambient_ibl(*targs, _t(irr), [_t(m) for m in mips], _t(lut))
    assert _ambient_share(got.numpy(), want) >= 0.999
    f0 = _t(args[0][..., :3])
    _close(ibl.env_brdf_approx(f0, targs[2], targs[3]).numpy(),
           jax_ibl.env_brdf_approx(jnp.asarray(args[0][..., :3]), jargs[2], jargs[3]), 1e-6)
    _close(ibl.sh9_irradiance(_t(sh), targs[4]).numpy(),
           jax_ibl.sh9_irradiance(sh, jargs[4]), 1e-6)


# --- counterparts of tests/test_ibl.py -------------------------------------


def test_face_uv_roundtrip():
    d = _dirs(512)
    face, u, v = cm.direction_to_face_uv(_t(d))
    dirs = cm.face_directions(64, "cpu").numpy()
    ui = np.clip((u.numpy() * 64).astype(int), 0, 63)
    vi = np.clip((v.numpy() * 64).astype(int), 0, 63)
    assert np.sum(dirs[face.numpy(), vi, ui] * d, axis=-1).min() > 0.999


def test_sample_constant_cube():
    cube = torch.ones(6, 16, 16, 3) * torch.tensor([0.2, 0.4, 0.8])
    d = m3.normalize(torch.tensor([[1.0, 0.3, -0.2], [0, -1, 0], [0.1, 0.1, 1.0]]))
    np.testing.assert_allclose(cm.sample_cubemap(cube, d).numpy(),
                               np.tile([0.2, 0.4, 0.8], (3, 1)), atol=1e-5)


def test_equirect_to_cube_poles_and_equator():
    h, w = 64, 128
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.concatenate([v, 1.0 - v, np.zeros_like(v)], -1) * np.ones((1, w, 1), np.float32)
    cube = cm.equirect_to_cube(_t(img), 32)
    _close(cube.numpy(), jax_cm.equirect_to_cube(jnp.asarray(img), 32), 1e-5)
    up = cm.sample_cubemap(cube, torch.tensor([[0.0, 1.0, 0.0]]))[0]
    dn = cm.sample_cubemap(cube, torch.tensor([[0.0, -1.0, 0.0]]))[0]
    assert up[0] < 0.1 and up[1] > 0.9
    assert dn[0] > 0.9 and dn[1] < 0.1


def test_irradiance_of_uniform_env_is_uniform():
    irr = ibl.irradiance_map(torch.ones(6, 16, 16, 3) * 2.0, resolution=8, samples=64)
    np.testing.assert_allclose(irr.numpy(), 2.0, rtol=0.05)


def test_prefilter_mip0_close_to_mirror():
    cube = torch.zeros(6, 32, 32, 3)
    cube[0] = 10.0
    mip0 = ibl.prefilter_env_mip(cube, 0.02, 32, samples=64)
    assert cm.sample_cubemap(mip0, torch.tensor([[1.0, 0.0, 0.0]]))[0, 0] > 7.0
    assert cm.sample_cubemap(mip0, torch.tensor([[-1.0, 0.0, 0.0]]))[0, 0] < 1.0


def test_brdf_lut_ranges():
    lut = ibl.brdf_lut(resolution=32, samples=64, device="cpu").numpy()
    assert lut.shape == (32, 32, 2)
    assert (lut >= -1e-3).all() and (lut[..., 0] <= 1.5).all()
    assert lut[2, -1, 0] > lut[30, -1, 0] - 0.3


def test_ambient_ibl_packed_tracks_list_path():
    """The packed stack with the analytic BRDF tracks the list of mips with
    the LUT (the reference's own bounds), and at integer lods the stack
    sampler reproduces sample_cubemap on that level."""
    rng = np.random.default_rng(3)
    cube = _t(rng.uniform(0.1, 1.0, (6, 16, 16, 3)).astype(np.float32))
    mips = ibl.prefiltered_env_mips(cube, num_mips=3, samples=32)
    lut = ibl.brdf_lut(resolution=32, samples=128, device="cpu")
    stack = torch.stack([cm.upsample_cubemap(m, 16) for m in mips])
    args = [_t(a) for a in _surface(16, 16, 4)]
    args[3] = torch.ones(16, 16)
    ref = ibl.ambient_ibl(*args, cube, list(stack.unbind()), lut).numpy()
    got = ibl.ambient_ibl_packed(*args, cube, stack).numpy()
    assert np.abs(got - ref).max() < 0.25 and np.abs(got - ref).mean() < 0.04
    d = m3.normalize(_t(rng.normal(size=(64, 3)).astype(np.float32)))
    for k in range(stack.shape[0]):
        np.testing.assert_allclose(
            cm.sample_cubemap_lod_stack(stack, d, torch.full((64,), float(k))).numpy(),
            cm.sample_cubemap(stack[k], d).numpy(), atol=1e-6)


def test_sh9_matches_irradiance_convolution():
    d = cm.face_directions(16, "cpu")
    t = torch.clamp(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    env = torch.tensor([0.9, 0.7, 0.5]) * (1.0 - t) + torch.tensor([0.2, 0.4, 0.9]) * t
    sh = ibl.sh9_project(env)
    irr = ibl.irradiance_map(env, resolution=16, samples=512)
    n = torch.nn.functional.normalize(torch.randn(256, 3, generator=torch.Generator()
                                                  .manual_seed(0)), dim=-1)
    want = cm.sample_cubemap(irr, n)
    assert float(((ibl.sh9_irradiance(sh, n) - want).abs() / (want.abs() + 1e-3)).max()) < 0.12


# --- the samplers the IBL path added ---------------------------------------


@pytest.mark.parametrize("wrap", ["clamp", "repeat", "mirror"])
def test_sample_bilinear_and_nearest_match_reference(wrap):
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 4, (13, 17, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (4000, 2)).astype(np.float32)
    _close(sampling.sample_bilinear(_t(img), _t(uv), wrap).numpy(),
           jax_sampling.sample_bilinear(jnp.asarray(img), jnp.asarray(uv), wrap), 1e-6)
    np.testing.assert_array_equal(
        sampling.sample_nearest(_t(img), _t(uv), wrap).numpy(),
        np.asarray(jax_sampling.sample_nearest(jnp.asarray(img), jnp.asarray(uv), wrap)))


def test_blit_identity_and_resize():
    img = _t(np.random.default_rng(6).uniform(0, 4, (32, 48, 3)).astype(np.float32))
    assert sampling.blit(img, (32, 48)) is img
    up = sampling.blit(img, (64, 96))
    _close(up.numpy(), jax_sampling.blit(jnp.asarray(img.numpy()), (64, 96)), 1e-6)
    np.testing.assert_allclose(float(up.mean()), float(img.mean()), rtol=0.02)
    _close(sampling.blit(img, (20, 30), filter="nearest").numpy(),
           jax_sampling.blit(jnp.asarray(img.numpy()), (20, 30), filter="nearest"), 0.0)
