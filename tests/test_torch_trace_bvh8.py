"""The path tracer on the BVH8 route against the JAX package's, on the CPU.

The reference's scene is carried across (``trace_scene_from_numpy``, the
BVH8 table included) and both packages draw the same uniforms
(``jax_uniforms``); bars as ``test_torch_path_tracer.py``'s: the ray count
equal, radiance within 1e-3 * (1 + |ref|) on >= 99% of pixels.
- ``tracer="bvh8"``: no sweep built (so no swizzle and no bounce sort, as
  the reference's defaults follow the sweep), every pass through the BVH8
  traversal; ``render`` at 32x32, 2 spp, 3 bounces;
- the routing: with ``SMEM_BUDGET`` patched in both packages to the scalar
  table of one 32x32 sample, a ``sample_batch=2`` render (bounce sort and
  swizzle on) sends every pass to the BVH8 traversal in both, counted at
  each package's ``_isect``;
- ``camera_rays``: origins and directions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu.raytracing import sweep as jax_sweep
from sailor_tpu_torch.raytracing import path_tracer as pt
from sailor_tpu_torch.raytracing import sweep
from test_torch_path_tracer import _carry, _soup, jax_uniforms
from test_torch_scenes import release_jax_executables  # noqa: F401

W = H = 32
SPP, BOUNCES = 2, 3


def _camera():
    cam = jnp.asarray([0.0, 4.0, 9.0])
    view = jax_m3.look_at(cam, jnp.asarray([0.0, 0.6, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 100.0)
    return cam, view, proj


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _count_routes(monkeypatch, sweep_mod, bvh_mod, name):
    counts = {"sweep": 0, "bvh8": 0}
    for route, mod in (("sweep", sweep_mod), ("bvh8", bvh_mod)):
        def counted(*args, _f=getattr(mod, name), _r=route, **kw):
            counts[_r] += 1
            return _f(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return counts


def _close(got, want):
    want = np.asarray(want)
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    return close.mean()


def test_render_bvh8_matches_reference():
    soup = _soup(None)
    ref = jax_pt.scene_from_mesh(soup, tracer="bvh8")
    assert ref.sweep is None
    got_scene = pt.scene_from_mesh(soup, tracer="bvh8", device="cpu")
    assert got_scene.sweep is None
    np.testing.assert_array_equal(got_scene.bvh.table.numpy().view(np.int32),
                                  np.asarray(ref.bvh.table).view(np.int32))
    cam, view, proj = _camera()
    key = jax.random.PRNGKey(3)
    want, want_rays = jax_pt.render(ref, cam, view, proj, width=W, height=H, spp=SPP,
                                    max_bounces=BOUNCES, key=key)
    assert pt.rays_per_sample(W, H, swizzle=False) == W * H
    uniforms = jax_uniforms(key, SPP, BOUNCES, W * H)
    got, rays = pt.render(_carry(ref), *_torch(cam, view, proj), width=W, height=H, spp=SPP,
                          max_bounces=BOUNCES, uniforms=torch.from_numpy(uniforms))
    assert float(rays) == float(want_rays) > 2 * W * H * SPP
    share = _close(got, want)
    assert share >= 0.99, share


def test_routed_render_matches_reference(monkeypatch):
    """Both packages leave the sweep for the BVH8 traversal by the same rule."""
    ref = jax_pt.scene_from_mesh(_soup(None))
    scene = _carry(ref)
    r = pt.rays_per_sample(W, H)
    budget = sweep.scalar_bytes(scene.sweep, r)
    assert budget == jax_sweep.scalar_bytes(ref.sweep, r) < sweep.scalar_bytes(scene.sweep, 2 * r)
    monkeypatch.setattr(jax_sweep, "SMEM_BUDGET", budget)
    monkeypatch.setattr(sweep, "SMEM_BUDGET", budget)
    jax.clear_caches()  # the reference routes while it traces
    want_counts = _count_routes(monkeypatch, jax_pt.sweep_mod, jax_pt.bvh_mod, "intersect")
    got_counts = _count_routes(monkeypatch, pt.sweep_mod, pt.bvh8_mod, "intersect")
    cam, view, proj = _camera()
    key = jax.random.PRNGKey(4)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=BOUNCES, sample_batch=2,
              sort_bounces=True, swizzle=True)
    want, want_rays = jax_pt.render(ref, cam, view, proj, key=key, **kw)
    uniforms = jax_uniforms(key, SPP, BOUNCES, r, sample_batch=2)
    got, rays = pt.render(scene, *_torch(cam, view, proj), uniforms=torch.from_numpy(uniforms),
                          **kw)
    # the reference traces each pass of its scan once: one call a pass kind
    assert want_counts == {"sweep": 0, "bvh8": 2 * BOUNCES}
    assert got_counts == {"sweep": 0, "bvh8": 2 * BOUNCES * SPP // 2}
    assert float(rays) == float(want_rays) > 2 * W * H * SPP
    share = _close(got, want)
    assert share >= 0.99, share


@pytest.mark.parametrize("jitter", [(0.5, 0.5), (0.0, 0.99)])
def test_camera_rays_matches_reference(jitter):
    cam, view, proj = _camera()
    o_ref, d_ref = jax_pt.camera_rays(cam, view, proj, 48, 40, *jitter)
    o, d = pt.camera_rays(*_torch(cam, view, proj), 48, 40, *jitter)
    assert o.shape == d.shape == (48 * 40, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
