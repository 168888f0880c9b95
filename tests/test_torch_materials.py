"""The port's texture stacks and samplers against the JAX package's, on the
CPU (``assets/materials.py``, the path tracer's side).

- tables exact: ``stack_textures`` (nearest resize of images of other
  sizes), ``build_mip_stack``, ``_mip_chain``, ``_quad_fold`` (repeat and
  clamp) and ``build_quad_stack_blocks`` with float rows and with u8 rows
  (``quantize``; the reference packs four u8 lanes into an int32, which
  the test unpacks);
- samplers on a uv grid from -1.25 to 2.25 (wrapping both ways), every
  texel centre and texel edge of the 16x16 mip 0, random uv, at lods from
  -1 to 4 (clamped to the 3 levels) with whole levels among them, and
  layers from -1 (clamped) to 2: ``_sample_texture_stack`` and
  ``sample_texture_lod`` exact, ``sample_quad_blocks`` exact on float rows
  and with repeat/clamp and bilinear/nearest per sample, and on u8 rows
  with the sRGB decode within 2e-7 (``x ** 2.2``, an ulp between the
  packages' pow).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import materials as jax_mat
from sailor_tpu_torch.assets import materials as mat
from test_torch_scenes import release_jax_executables  # noqa: F401

S = 16


def _images():
    rng = np.random.default_rng(0)
    return [rng.random((S, S, 4)).astype(np.float32),
            rng.random((2 * S, S // 2, 4)).astype(np.float32),   # resized both ways
            rng.random((S + 3, S - 5, 4)).astype(np.float32)]


def _uv_lod(n_rand=4000):
    rng = np.random.default_rng(1)
    g = np.linspace(-1.25, 2.25, 48).astype(np.float32)
    grid = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    k = np.arange(S, dtype=np.float32)
    centres = np.stack(np.meshgrid((k + 0.5) / S, (k + 0.5) / S), -1).reshape(-1, 2)
    edges = np.stack(np.meshgrid(k / S, k / S), -1).reshape(-1, 2)
    uv = np.concatenate([grid, centres, edges, rng.uniform(-3, 3, (n_rand, 2))]).astype(np.float32)
    lod = rng.uniform(-1.0, 4.0, len(uv)).astype(np.float32)
    lod[::3] = np.round(lod[::3])
    layer = rng.integers(-1, 3, len(uv)).astype(np.int32)
    return uv, lod, layer


def test_texture_tables_match_reference():
    stack = mat.stack_textures(_images(), S)
    want = np.asarray(jax_mat.stack_textures(_images(), S))
    np.testing.assert_array_equal(stack, want)
    assert mat.stack_textures([], 8).shape == (0, 8, 8, 4)
    flat, sizes = mat.build_mip_stack(stack)
    jflat, jsizes = jax_mat.build_mip_stack(want)
    assert sizes == jsizes == (16, 8, 4)
    np.testing.assert_array_equal(flat, np.asarray(jflat))
    for a, b in zip(mat._mip_chain(stack[1], sizes), jax_mat._mip_chain(want[1], jsizes)):
        np.testing.assert_array_equal(a, b)
    for clamp in (False, True):
        np.testing.assert_array_equal(mat._quad_fold(stack[2], clamp),
                                      jax_mat._quad_fold(want[2], clamp))


BLOCKS = [(np.array([0, -1, 1, 0, 2]), 4, (1.0, 1.0, 1.0, 1.0)),
          (np.array([-1, -1, 2, 2, -1]), 3, (0.5, 0.5, 1.0)),
          (np.array([-1] * 5), 3, (1.0, 1.0, 1.0))]   # dropped: no material has it
WRAP = np.array([0, 1, 0], np.int32)
FILT = np.array([0, 0, 1], np.int32)


@pytest.mark.parametrize("quantize", [None, (True, False)], ids=["float", "u8_srgb"])
def test_quad_stack_blocks_match_reference(quantize):
    stack = mat.stack_textures(_images(), S)
    got = mat.build_quad_stack_blocks(stack, BLOCKS, WRAP, FILT, quantize=quantize)
    want = jax_mat.build_quad_stack_blocks(stack, BLOCKS, WRAP, FILT, quantize=quantize)
    rows = np.asarray(want[0])
    if quantize is not None:
        assert got[0].dtype == np.uint8
        rows = rows.view(np.uint8)[:, :got[0].shape[1]]  # the reference's int32 lanes
    np.testing.assert_array_equal(got[0], rows)
    for a, b in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[4] == want[4] and got[5] == want[5]

    uv, lod, _ = _uv_lod()
    rng = np.random.default_rng(2)
    group = rng.integers(0, int(got[1].max()) + 1, len(uv)).astype(np.int32)
    wrapc, nearest = rng.random(len(uv)) < 0.5, rng.random(len(uv)) < 0.3
    srgb = (True, False) if quantize else ()
    ref = jax_mat.sample_quad_blocks(want[0], want[5], want[4], jnp.asarray(group),
                                     jnp.asarray(uv), jnp.asarray(lod), jnp.asarray(wrapc),
                                     jnp.asarray(nearest), srgb=srgb)
    out = mat.sample_quad_blocks(torch.from_numpy(got[0]), got[5], got[4],
                                 torch.from_numpy(group), torch.from_numpy(uv),
                                 torch.from_numpy(lod), torch.from_numpy(wrapc),
                                 torch.from_numpy(nearest), srgb=srgb)
    assert len(out) == len(ref) == 2
    for a, b in zip(ref, out):
        a = np.asarray(a)
        if quantize is None:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-7)


def test_stack_and_lod_samplers_match_reference():
    stack = mat.stack_textures(_images(), S)
    flat, sizes = mat.build_mip_stack(stack)
    uv, lod, layer = _uv_lod()
    want = jax_mat._sample_texture_stack(jnp.asarray(stack), jnp.asarray(layer), jnp.asarray(uv))
    got = mat._sample_texture_stack(torch.from_numpy(stack), torch.from_numpy(layer),
                                    torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_mat.sample_texture_lod(jnp.asarray(flat), 3, sizes, jnp.asarray(layer),
                                      jnp.asarray(uv), jnp.asarray(lod))
    got = mat.sample_texture_lod(torch.from_numpy(flat), 3, sizes, torch.from_numpy(layer),
                                 torch.from_numpy(uv), torch.from_numpy(lod))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
