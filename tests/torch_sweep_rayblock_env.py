"""Run by ``tests/test_torch_sweep_rayblock.py`` with
``SAILOR_SWEEP_RAY_BLOCK=1024 SAILOR_SWEEP_SUB=128`` in its environment (not
collected): both packages read the pair at import, so it needs a process of
its own.

Checks that both packages' ``sweep.RAY_BLOCK`` and ``sweep.SUB`` are the
environment's, that both render paths pad to the swizzle of that pair, and
that a 32x32 render of the port's own scene (1 spp, 2 bounces, bounce sort
and swizzle on) with the reference's uniforms equals the reference's render
of its scene at ``test_torch_path_tracer.py``'s bar: the same ray count,
radiance within 1e-3 * (1 + |ref|) on >= 99% of pixels. Prints one line
ending in the share of close pixels.

    SAILOR_SWEEP_RAY_BLOCK=1024 SAILOR_SWEEP_SUB=128 JAX_PLATFORMS=cpu \\
        python tests/torch_sweep_rayblock_env.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # the environment may pre-seed another backend

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sailor_tpu.assets import shader_cache  # noqa: E402
from sailor_tpu.core import math3d as jax_m3  # noqa: E402
from sailor_tpu.raytracing import path_tracer as jax_pt  # noqa: E402
from sailor_tpu.raytracing import sweep as jax_sweep  # noqa: E402
from sailor_tpu_torch.raytracing import path_tracer as pt  # noqa: E402
from sailor_tpu_torch.raytracing import sweep  # noqa: E402
from test_torch_path_tracer import _soup, jax_uniforms  # noqa: E402


def main() -> int:
    shader_cache.rescope_for_cpu()
    want = (int(os.environ["SAILOR_SWEEP_RAY_BLOCK"]), int(os.environ["SAILOR_SWEEP_SUB"]))
    for mod in (jax_sweep, sweep):
        assert (mod.RAY_BLOCK, mod.SUB) == want, (mod.__name__, mod.RAY_BLOCK, mod.SUB)
    w = h = 32
    spp, bounces = 1, 2
    swizzled = pt.rays_per_sample(w, h)
    assert swizzled == jax_pt._swizzle_maps(h, w, *want)[2] == pt._swizzle_maps(h, w, *want)[2]
    ref = jax_pt.scene_from_mesh(_soup(None), None)
    scene = pt.scene_from_mesh(_soup(None), device="cpu")
    assert ref.sweep.n_clusters == scene.sweep.n_clusters
    cam = jnp.asarray([0.0, 4.0, 9.0])
    view = jax_m3.look_at(cam, jnp.asarray([0.0, 0.6, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 100.0)
    key = jax.random.PRNGKey(3)
    ref_img, ref_rays = jax_pt.render(ref, cam, view, proj, width=w, height=h, spp=spp,
                                      max_bounces=bounces, key=key, sort_bounces=True,
                                      swizzle=True)
    uniforms = jax_uniforms(key, spp, bounces, swizzled)
    img, rays = pt.render(scene, *(torch.from_numpy(np.array(a)) for a in (cam, view, proj)),
                          width=w, height=h, spp=spp, max_bounces=bounces,
                          uniforms=torch.from_numpy(uniforms), sort_bounces=True)
    ref_img = np.asarray(ref_img)
    assert float(rays) == float(ref_rays) > w * h * spp, (float(rays), float(ref_rays))
    close = np.abs(img.numpy() - ref_img).max(-1) <= 1e-3 * (1 + np.abs(ref_img).max(-1))
    print(f"ray_block={sweep.RAY_BLOCK} sub={sweep.SUB} rays_per_sample={swizzled} "
          f"rays={float(rays)} render close={close.mean():.5f}")
    assert close.mean() >= 0.99, close.mean()
    return 0


if __name__ == "__main__":
    sys.exit(main())
