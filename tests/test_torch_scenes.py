"""Shared inputs of the port's parity tests, and the test of its flagship scene.

The JAX package builds the reference scene (``bench._build_scene``, the
flagship scene at a small size); ``scene_arrays`` turns it into the numpy
dict that ``sailor_tpu_torch.rhi.scene_view.scene_from_numpy`` takes, so
both packages render from identical inputs.
"""

import jax
import numpy as np
import pytest
import torch

import bench
from sailor_tpu_torch.rhi.scene_view import (
    FRAME_KEYS, GEOMETRY_KEYS, LIGHT_KEYS, scene_from_numpy)
from sailor_tpu_torch.scenes import flagship_scene

# The suite runs in several xdist workers on a few cores. PyTorch's own
# intra-op thread pool in every worker oversubscribes them (its OpenMP
# threads spin while they wait) and slowed these tests about fivefold.
torch.set_num_threads(1)

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
    out["attrs_packed"] = np.asarray(scene.attrs_packed)
    return out


def torch_scene(scene):
    return scene_from_numpy(scene_arrays(scene), "cpu")


def test_flagship_scene_matches_bench_scene():
    """Same seed, same RNG calls: the port's flagship_scene reproduces the
    JAX package's benchmark scene. Geometry and lights are host numpy and
    match exactly; camera matrices are float32 math in two frameworks
    (tolerance 1e-6 relative)."""
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
