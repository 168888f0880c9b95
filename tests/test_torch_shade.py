"""Forward+ shading (B3) of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed: a G-buffer of mixed surfaces with
background holes, 40 lights of all three types, and the light lists that
the JAX package's own culling gives for them.

The port divides exactly where the reference's Pallas kernel calls
``pl.reciprocal(approx=True)``. In the reference's CPU interpreter that
approximate reciprocal rounds through bfloat16 (relative error up to
2^-8), so the kernel comparison runs twice: once with the reference's
``_rcp`` swapped for exact division, which the JAX package's plain
reference (pbr.shade_forward_plus) uses anyway, and once as it stands.

Tolerances, relative to max(|reference|, 1e-2):
- exact reciprocal: 1e-4. The formulas are the same, but the reference's
  compiled code fuses some products into adds and takes rsqrt from a
  refined estimate; the narrow GGX lobes of the rough-0.2 surfaces here
  amplify those last-bit differences to ~2e-5;
- interpreted reciprocal: 4 * 2^-8. A light's term multiplies up to four
  approximate reciprocals (attenuation, GGX D, the two Smith G factors),
  each off by up to 2^-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.kernels import light_culling as j_lc
from sailor_tpu.kernels import pbr as j_pbr
from sailor_tpu.kernels import pbr_pallas as j_pk
from sailor_tpu.kernels.lights import DIRECTIONAL, POINT, SPOT, Lights as JLights
from sailor_tpu_torch.kernels import pbr as t_pbr
from sailor_tpu_torch.kernels import pbr_kernel as t_pk
from sailor_tpu_torch.kernels.lights import Lights as TLights
from test_torch_scenes import jax_scene
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

W, H = 128, 64


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    n = 40
    types = [DIRECTIONAL] + list(rng.choice([POINT, POINT, SPOT], n - 1))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lkw = dict(types=types,
               positions=np.stack([rng.uniform(-6, 6, n), rng.uniform(0.3, 3.0, n),
                                   rng.uniform(-6, 6, n)], -1),
               directions=dirs, intensities=rng.uniform(0.3, 6, (n, 3)),
               attenuations=[[1, 0, 0.8]] * n,
               cutoffs=np.stack([np.full(n, 0.95), np.full(n, 0.7)], -1),
               radii=[0.0] + list(rng.uniform(2.0, 8.0, n - 1)))
    nrm = rng.normal(size=(H, W, 3))
    nrm[..., 1] = np.abs(nrm[..., 1]) + 0.5
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    cov = (rng.uniform(size=(H, W)) > 0.15).astype(np.float32)
    gb = dict(
        world_position=np.stack([rng.uniform(-6, 6, (H, W)), rng.uniform(0, 2, (H, W)),
                                 rng.uniform(-6, 6, (H, W))], -1) * cov[..., None],
        normal=np.where(cov[..., None] > 0, nrm, [0.0, 0.0, 1.0]),
        albedo=np.concatenate([rng.uniform(0.1, 0.9, (H, W, 3)), np.ones((H, W, 1))], -1)
        * cov[..., None],
        metallic=rng.choice([0.0, 0.0, 0.6, 1.0], (H, W)) * cov,
        roughness=np.where(cov > 0, rng.uniform(0.2, 1.0, (H, W)), 1.0),
        ao=np.ones((H, W)), emissive=rng.uniform(0, 0.2, (H, W, 3)) * cov[..., None],
        coverage=cov)
    gb = {k: np.asarray(v, np.float32) for k, v in gb.items()}
    frame = jax_scene(W, H, 2, 2).frame
    jl = JLights.from_host(**lkw)
    lin = np.asarray(rng.uniform(2, 20, (H, W)), np.float32)
    idx, counts = j_lc.cull_lights(jl, frame.view, frame.inv_projection, jnp.asarray(lin),
                                   tiles_y=H // 16, tiles_x=W // 16, viewport=(W, H),
                                   max_per_tile=32)
    cam = np.asarray([4.0, 5.0, 9.0], np.float32)
    return dict(lkw=lkw, gb=gb, idx=np.asarray(idx), counts=np.asarray(counts), cam=cam)


def _jax_gbuffer(gb):
    return j_pbr.GBuffer(**{k: jnp.asarray(v) for k, v in gb.items()})


def _torch_gbuffer(gb):
    return t_pbr.GBuffer(**{k: _t(v) for k, v in gb.items()})


def _close(got, ref, rtol=1e-4):
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    assert err.max() <= rtol, err.max()


@pytest.mark.parametrize("rcp", ["exact", "interpreted"])
def test_shade_kernel_matches_jax(inputs, monkeypatch, rcp):
    if rcp == "exact":
        monkeypatch.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()  # no kernel traced with the other reciprocal
    try:
        ref = np.asarray(j_pk.shade_forward_plus_pallas(
            _jax_gbuffer(inputs["gb"]), JLights.from_host(**inputs["lkw"]),
            jnp.asarray(inputs["idx"]), jnp.asarray(inputs["cam"]),
            tile_light_counts=jnp.asarray(inputs["counts"])))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got = t_pk.shade_forward_plus_kernel(
        _torch_gbuffer(inputs["gb"]), TLights.from_host(**inputs["lkw"], device="cpu"),
        _t(inputs["idx"]), _t(inputs["cam"]),
        tile_light_counts=_t(inputs["counts"])).numpy()
    assert int(inputs["counts"].max()) > 3 and np.abs(ref).max() > 0.1
    _close(got, ref, rtol=1e-4 if rcp == "exact" else 4 * 2**-8)


def test_shade_kernel_with_shadow_matches_jax(inputs, monkeypatch):
    """The directional light times a shadow factor, through the port's
    gather-in-kernel path (the light table, LightIndices and the counts),
    against the reference kernel with exact division."""
    shadow = np.random.default_rng(4).uniform(0.0, 1.0, (H, W)).astype(np.float32)
    monkeypatch.setattr(j_pk, "_rcp", lambda x: 1.0 / x)
    jax.clear_caches()
    try:
        ref = np.asarray(j_pk.shade_forward_plus_pallas(
            _jax_gbuffer(inputs["gb"]), JLights.from_host(**inputs["lkw"]),
            jnp.asarray(inputs["idx"]), jnp.asarray(inputs["cam"]),
            shadow_factors=jnp.asarray(shadow), tile_light_counts=jnp.asarray(inputs["counts"])))
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    got = t_pk.shade_forward_plus_kernel(
        _torch_gbuffer(inputs["gb"]), TLights.from_host(**inputs["lkw"], device="cpu"),
        _t(inputs["idx"]), _t(inputs["cam"]), shadow_factors=_t(shadow),
        tile_light_counts=_t(inputs["counts"])).numpy()
    unshadowed = t_pk.shade_forward_plus_kernel(
        _torch_gbuffer(inputs["gb"]), TLights.from_host(**inputs["lkw"], device="cpu"),
        _t(inputs["idx"]), _t(inputs["cam"]), tile_light_counts=_t(inputs["counts"])).numpy()
    assert np.abs(got - unshadowed).max() > 1e-2  # the shadow reaches the image
    _close(got, ref)


def test_shade_forward_plus_matches_jax(inputs):
    """The plain Forward+ loop (the JAX package's own reference) ported."""
    ref = np.asarray(j_pbr.shade_forward_plus(
        _jax_gbuffer(inputs["gb"]), JLights.from_host(**inputs["lkw"]),
        jnp.asarray(inputs["idx"]), jnp.asarray(inputs["cam"])))
    got = t_pbr.shade_forward_plus(
        _torch_gbuffer(inputs["gb"]), TLights.from_host(**inputs["lkw"], device="cpu"),
        _t(inputs["idx"]), _t(inputs["cam"])).numpy()
    _close(got, ref)


def test_shade_kernel_matches_plain_reference(inputs):
    """Both port paths agree: the kernel's per-tile slot loop (to each
    tile's count) and the chunked plain loop over all K slots."""
    args = (_torch_gbuffer(inputs["gb"]), TLights.from_host(**inputs["lkw"], device="cpu"),
            _t(inputs["idx"]), _t(inputs["cam"]))
    kernel = t_pk.shade_forward_plus_kernel(*args, tile_light_counts=_t(inputs["counts"]))
    _close(kernel.numpy(), t_pbr.shade_forward_plus(*args).numpy())
