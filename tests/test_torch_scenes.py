"""Shared inputs of the port's parity tests, and the test of its flagship scene.

The JAX package builds the reference scene (``bench._build_scene``, the
flagship scene at a small size); ``scene_arrays`` turns it into the numpy
dict that ``sailor_tpu_torch.rhi.scene_view.scene_from_numpy`` takes, so
both packages render from identical inputs.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import bench
from sailor_tpu_torch.rhi.scene_view import (
    FRAME_KEYS, GEOMETRY_KEYS, LIGHT_KEYS, scene_from_numpy)
from sailor_tpu_torch.kernels.sky import SkyParams
from sailor_tpu_torch.scenes import flagship_scene

# The suite runs in several xdist workers on a few cores. PyTorch's own
# intra-op thread pool in every worker oversubscribes them (its OpenMP
# threads spin while they wait) and slowed these tests about fivefold.
torch.set_num_threads(1)

# Keep the JAX package's AOT executable cache off in the workers, as
# `sailor_tpu.assets.aot_cache.enabled` means it to be in a CPU process that
# builds several graphs. `test_engine_aux.py::test_cli_main` calls
# `sailor_tpu.__main__.main(["--cpu", ...])`, which turns it on for the rest
# of its process with `os.environ.setdefault("SAILOR_AOT_CACHE", "1")`; every
# frame graph that worker builds afterwards then loads a stored executable,
# and XLA:CPU fails the second one it loads ("Buffer Definition Event:
# Function ... not found"). Each worker imports this module while it
# collects, before any test runs, so that `setdefault` finds the key set.
os.environ.setdefault("SAILOR_AOT_CACHE", "0")

# the slice's configuration, for both packages
SLICE_CONFIG = {
    "z_far": 150.0, "bin_capacity": 1024, "bin_rounds": 4,
    "max_lights_per_tile": 128, "pallas_shading": True, "fused_resolve": True,
    "raster_mode": "stream", "raster_worklist": True,
    "light_coarse_capacity": 256, "hiz_culling": False, "tonemap": "aces",
    "ldr_dither": True,
}
MINIMAL_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling",
                 "RenderScene", "EyeAdaptation"]
# the shadowed, HiZ-culled frame: bench.py's flagship config with the
# reference's defaults for HiZ culling, the CSM cache and the cascades, and
# DefaultRenderer.renderer's node order without the nodes not yet ported
SHADOW_HIZ_CONFIG = dict(
    SLICE_CONFIG, hiz_culling=True, csm_cache=True, shadow_resolution=1024,
    shadow_bin_capacity=512, shadow_stride=4)
SHADOW_HIZ_GRAPH = ["DepthPrepass", "LinearizeDepth", "LightCulling", "ShadowPrepass",
                    "DepthHighZ", "RenderScene", "EyeAdaptation"]
SHADOW_HIZ_VALUES = {"Shadow.EvsmBlurRadius": 4}
# the whole DefaultRenderer frame: bench.py's flagship config (bench.py:338-350)
# with the reference's defaults for the rest
FULL_CONFIG = dict(
    SHADOW_HIZ_CONFIG, env_resolution=32, raster_mxu=False, sky_cache=True,
    sky_downsample=2, sky_clouds=True, cloud_stride=2, sky_cache_hz=4.0,
    env_incremental=True, ao_stride=2, ibl_stride=4)


@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
    """Drop a module's compiled JAX executables when the module ends. An
    XLA:CPU process fails after a few hundred compiles (tests/conftest.py);
    the parity modules compile the reference in interpret mode, and the
    worker that runs them may run the suite's heaviest graphs next. Each
    module that imports this fixture gets it."""
    yield
    jax.clear_caches()


def jax_scene(width=256, height=128, num_lights=24, num_objects=10, seed=11):
    return bench._build_scene(width, height, num_lights, num_objects, rng_seed=seed)


def scene_arrays(scene) -> dict:
    out = {f"geometry.{f}": np.asarray(getattr(scene.geometry, f)) for f in GEOMETRY_KEYS}
    out.update({f"lights.{f}": np.asarray(getattr(scene.lights, f)) for f in LIGHT_KEYS})
    out.update({f"frame.{f}": np.asarray(getattr(scene.frame, f)) for f in FRAME_KEYS})
    out.update({f"prev_frame.{f}": np.asarray(getattr(scene.prev_frame, f))
                for f in FRAME_KEYS})
    out["attrs_packed"] = np.asarray(scene.attrs_packed)
    out.update({f"sky.{f.name}": np.asarray(getattr(scene.sky, f.name))
                for f in dataclasses.fields(SkyParams)})
    if scene.star_dirs.shape[0]:
        out["star_dirs"] = np.asarray(scene.star_dirs)
        out["star_colors"] = np.asarray(scene.star_colors)
    return out


def torch_scene(scene):
    return scene_from_numpy(scene_arrays(scene), "cpu")


def test_flagship_scene_matches_bench_scene():
    """Same seed, same RNG calls: the port's flagship_scene reproduces the
    JAX package's benchmark scene. Geometry, lights and the sun direction
    are host numpy and match exactly; camera matrices are float32 math in
    two frameworks (tolerance 1e-6 relative)."""
    ref = scene_arrays(jax_scene(192, 128, 12, 6))
    got = flagship_scene(192, 128, 12, 6, device="cpu")
    for f in GEOMETRY_KEYS:
        np.testing.assert_array_equal(getattr(got.geometry, f).numpy(), ref[f"geometry.{f}"])
    for f in LIGHT_KEYS:
        v = getattr(got.lights, f)
        np.testing.assert_array_equal(np.asarray(v.numpy() if torch.is_tensor(v) else v),
                                      ref[f"lights.{f}"])
    for f in FRAME_KEYS:
        np.testing.assert_allclose(getattr(got.frame, f).numpy(), ref[f"frame.{f}"],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.attrs_packed.numpy(), ref["attrs_packed"])
    np.testing.assert_array_equal(got.sky.sun_direction, ref["sky.sun_direction"])


def test_tracer_scene_matches_bench_trace_scene():
    """``tracer_soup`` and ``tracer_camera`` rebuild bench.py's path-tracer
    scene (``bench_trace``): the soup exactly (18,434 triangles, 73 sweep
    clusters of 256), the camera within 1e-6 (float32 math in two
    frameworks)."""
    import jax.numpy as jnp

    from sailor_tpu.assets import primitives as jax_primitives
    from sailor_tpu.core import math3d as jax_m3
    from sailor_tpu_torch.raytracing import sweep
    from sailor_tpu_torch.scenes import tracer_camera, tracer_soup

    meshes = [(jax_primitives.plane(40.0), np.eye(4))]
    for i in range(8):
        t = np.eye(4)
        t[:3, 3] = [(i % 4 - 1.5) * 2.2, 0.9, (i // 4 - 0.5) * 2.4]
        meshes.append((jax_primitives.uv_sphere(0.9, 24, 48), t))
    ref = jax_primitives.merge(meshes)
    got = tracer_soup()
    for k in ("position", "normal", "uv", "indices", "material_id"):
        np.testing.assert_array_equal(got[k], ref[k], k)
    assert len(got["indices"]) == 18434
    p, i = got["position"], got["indices"]
    assert sweep.build_arrays(p[i[:, 0]], p[i[:, 1]], p[i[:, 2]])["g_cluster"].shape[0] == 73
    cam = jnp.asarray([0.0, 4.0, 9.0])
    want = (cam, jax_m3.look_at(cam, jnp.asarray([0.0, 0.6, 0.0]), jnp.asarray([0.0, 1.0, 0.0])),
            jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 100.0))
    for a, b in zip(want, tracer_camera("cpu")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
