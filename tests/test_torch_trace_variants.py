"""The rest of the path tracer against the JAX package's, on the CPU: one
32x32 render (2 spp, 3 bounces) per variant, both packages on the same
scene and the reference's own uniforms (``jax_uniforms``), at the tracer's
parity bar: equal ray count, radiance within 1e-3 * (1 + |ref|) on >= 99%
of pixels.

Variants: the env-map sky (a 16x32 bake; both render on the reference's
bake, since the bakes differ by ~2e-5, ``test_torch_sky.py``); each texture
kind of the reference's texture tests (an 8x8 albedo, normal, ORM or
emissive map on a plane seen from above) through the quad rows at the
ray-cone LOD, and the albedo map with ``SAILOR_TRACE_MIPS=0`` through mip
0; the material balls with sky and procedural maps on the ground;
``sample_batch=2``; ``sort_bounces=False, swizzle=False``; and
``SAILOR_SWEEP_SORT=1`` (rays sorted inside every intersector pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.kernels import sky as jax_sky
from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu_torch.kernels import sky
from sailor_tpu_torch.raytracing import path_tracer as pt
from test_torch_path_tracer import BUILDS, jax_uniforms
from test_torch_scenes import release_jax_executables  # noqa: F401


def _top_down():
    cam = jnp.asarray([0.0, 6.0, 0.01])
    view = jax_m3.look_at(cam, jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([0.0, 0.0, -1.0]))
    return cam, view, jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 50.0)


def _front():
    cam = jnp.asarray([0.0, 4.0, 9.0])
    view = jax_m3.look_at(cam, jnp.asarray([0.0, 0.6, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    return cam, view, jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 100.0)


# name: (scene, camera, scene_from_mesh keywords, render keywords, environment)
VARIANTS = {
    "env_sky": ("default", _front, {"sky": "sky", "env_size": (16, 32)}, {}, {}),
    "albedo_map": ("albedo_map", _top_down, {}, {}, {}),
    "normal_map": ("normal_map", _top_down, {}, {}, {}),
    "orm_map": ("orm_map", _top_down, {}, {}, {}),
    "emissive_map": ("emissive_map", _top_down, {}, {}, {}),
    "albedo_map_mip0": ("albedo_map", _top_down, {}, {}, {"SAILOR_TRACE_MIPS": "0"}),
    "balls_sky_textured": ("balls", _front, {"sky": "sky", "env_size": (16, 32)},
                           {"sort_bounces": True}, {}),
    "sample_batch2": ("default", _front, {}, {"sample_batch": 2, "sort_bounces": True}, {}),
    "unsorted_unswizzled": ("default", _front, {}, {"sort_bounces": False, "swizzle": False},
                            {}),
    "sorted_rays": ("default", _front, {}, {"sort_bounces": True}, {"SAILOR_SWEEP_SORT": "1"}),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_render_variant_matches_reference(name, monkeypatch):
    """The rest of the tracer at the parity bar, with the reference's own
    uniforms: equal ray count, radiance within 1e-3 * (1 + |ref|) on >= 99%
    of pixels."""
    build, camera, scene_kw, render_kw, env = VARIANTS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    soup, mats = BUILDS[build]()
    jkw, tkw = dict(scene_kw), dict(scene_kw)
    if "sky" in scene_kw:
        jkw["sky"] = jax_sky.SkyParams.default()
        tkw["sky"] = sky.SkyParams.default()
    ref = jax_pt.scene_from_mesh(soup, mats, **jkw)
    scene = pt.scene_from_mesh(soup, mats, device="cpu", **tkw)
    if "sky" in scene_kw:  # render both on the same bake: the bakes differ by ~2e-5
        scene.env_map = torch.from_numpy(np.asarray(ref.env_map))
    w = h = 32
    spp, bounces = 2, 3
    cam, view, proj = camera()
    key = jax.random.PRNGKey(7)
    jax.clear_caches()  # the environment knobs are read while the reference traces
    want, want_rays = jax_pt.render(ref, cam, view, proj, width=w, height=h, spp=spp,
                                    max_bounces=bounces, key=key, **render_kw)
    sb = render_kw.get("sample_batch", 1)
    r = pt.rays_per_sample(w, h, render_kw.get("swizzle", True))
    uniforms = jax_uniforms(key, spp, bounces, r, sb)
    got, rays = pt.render(scene, *(torch.from_numpy(np.array(a)) for a in (cam, view, proj)),
                          width=w, height=h, spp=spp, max_bounces=bounces,
                          uniforms=torch.from_numpy(uniforms), **render_kw)
    want = np.asarray(want)
    assert float(rays) == float(want_rays) > w * h * spp
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    assert close.mean() >= 0.99, close.mean()
    jax.clear_caches()
