"""The port's MaterialTable against the JAX package's, on the CPU
(``assets/materials.py``, the raster path's side).

Five materials over three 16x16 textures (one a normal map), queues
Opaque, Masked and Transparent, and per-texture sampler state (repeat or
clamp, bilinear or nearest):

- tables exact: ``MaterialTable.from_host``'s parameter rows, queues,
  mip table, quad rows (u8 with the sRGB albedo, the reference's int32
  lanes unpacked; float with ``SAILOR_QUAD_U8=0``; and the split mip-0
  form with ``SAILOR_QUAD_SPLIT=1``), groups, sampler state, the Masked
  groups' alpha rows and ``alpha_group``, ``quad_offsets``,
  ``quad_srgb``; ``from_arrays`` of the reference's table equals
  ``from_host``;
- samplers on a uv grid from -1.25 to 2.25, every texel centre and edge
  and random uv, at lods from -1 to 4 (whole and half levels among them),
  per material: ``sample_combined``, ``sample_alpha`` (nearest mip),
  ``sample_normal``, ``sample_texture`` (trilinear and mip 0) and
  ``sample`` (with and without a lod): exact on float rows, within 2e-7 on
  u8 rows with the sRGB decode (``x ** 2.2``, an ulp between the packages'
  pow), in each table form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import materials as jax_mat
from sailor_tpu_torch.assets import materials as mat
from test_torch_scenes import release_jax_executables  # noqa: F401

S = 16
FORMS = {"u8": {}, "float": {"SAILOR_QUAD_U8": "0"},
         "u8_split": {"SAILOR_QUAD_SPLIT": "1"}, "float_split": {
             "SAILOR_QUAD_U8": "0", "SAILOR_QUAD_SPLIT": "1"}}


def host_table():
    """(table, images, sampler_meta): material 0 opaque untextured, 1
    opaque with albedo and normal maps, 2 masked with a striped-alpha
    albedo (clamped), 3 transparent with the albedo map, 4 masked with the
    nearest-filtered map."""
    rng = np.random.default_rng(3)
    y = (np.arange(S)[:, None] + 0.5) / S
    albedo = rng.random((S, S, 4)).astype(np.float32)
    albedo[..., 3] = 1.0
    stripes = albedo.copy()
    stripes[..., 3] = np.broadcast_to(np.floor(8 * y) % 2, (S, S))
    normal = rng.random((S, S, 4)).astype(np.float32)
    table = {
        "albedo": rng.random((5, 3)).astype(np.float32),
        "metallic": rng.random(5).astype(np.float32),
        "roughness": rng.random(5).astype(np.float32),
        "emissive": rng.random((5, 3)).astype(np.float32) * 0.1,
        "albedo_texture": np.array([-1, 0, 1, 0, 2], np.int32),
        "normal_texture": np.array([-1, 3, -1, -1, 3], np.int32),
        "queue": ["Opaque", "Opaque", "Masked", "Transparent", 1],
        "alpha_cutoff": np.array([0.5, 0.5, 0.5, 0.5, 0.3], np.float32),
        "opacity": np.array([1, 1, 1, 0.5, 1], np.float32),
    }
    meta = [None, {"clamping": "Clamp"}, {"filtration": "Nearest"}, {}]
    return table, [albedo, stripes, albedo[::-1].copy(), normal], meta


def _tables(monkeypatch, form):
    for k in ("SAILOR_QUAD_U8", "SAILOR_QUAD_SPLIT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in FORMS[form].items():
        monkeypatch.setenv(k, v)
    table, images, meta = host_table()
    want = jax_mat.MaterialTable.from_host(table, images, texture_size=S, sampler_meta=meta)
    got = mat.MaterialTable.from_host(table, images, texture_size=S, sampler_meta=meta,
                                      device="cpu")
    return got, want


def _rows(a, nbytes):
    a = np.asarray(a)
    return a.view(np.uint8)[:, :nbytes] if a.dtype == np.int32 else a


@pytest.mark.parametrize("form", list(FORMS))
def test_from_host_matches_reference(monkeypatch, form):
    got, want = _tables(monkeypatch, form)
    assert got.quad_offsets == want.quad_offsets == (("albedo", (0, 4)), ("normal", (16, 3)))
    assert got.quad_srgb == want.quad_srgb == (() if "float" in form else (True, False))
    assert got.mip_sizes == want.mip_sizes == (16, 8, 4)
    assert (got.has_masked, got.has_transparent, got.quad_has_normal) == (True, True, True)
    assert (want.has_masked, want.has_transparent, want.quad_has_normal) == (True, True, True)
    nbytes = 28
    for f in mat.TENSOR_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        w = _rows(w, nbytes) if f in ("tex_quad", "tex_quad_mip0") else np.asarray(w)
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert (got.tex_quad_mip0 is not None) == ("split" in form)
    # the alpha rows hold the Masked materials' groups alone (2 of 5 groups)
    assert got.tex_quad_alpha.shape[0] == 2 * sum(s * s for s in got.mip_sizes)
    again = mat.MaterialTable.from_arrays(
        {f: getattr(want, f) for f in mat.TENSOR_FIELDS + mat.HOST_FIELDS}, device="cpu")
    for f in mat.TENSOR_FIELDS:
        g, a = getattr(got, f), getattr(again, f)
        assert (g is None and a is None) or torch.equal(g, a), f
    assert all(getattr(got, f) == getattr(again, f) for f in mat.HOST_FIELDS)


def _uv_lod_mat(n_rand=3000):
    rng = np.random.default_rng(1)
    g = np.linspace(-1.25, 2.25, 40).astype(np.float32)
    grid = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    k = np.arange(S, dtype=np.float32)
    centres = np.stack(np.meshgrid((k + 0.5) / S, (k + 0.5) / S), -1).reshape(-1, 2)
    edges = np.stack(np.meshgrid(k / S, k / S), -1).reshape(-1, 2)
    uv = np.concatenate([grid, centres, edges, rng.uniform(-3, 3, (n_rand, 2))]).astype(np.float32)
    lod = rng.uniform(-1.0, 4.0, len(uv)).astype(np.float32)
    lod[::4] = np.round(lod[::4])
    lod[1::4] = np.round(lod[1::4]) + 0.5
    mid = rng.integers(0, 5, len(uv)).astype(np.int32)
    return uv, lod, mid


def _check(got, want, exact):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g is None:
            assert w is None
            continue
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape
        if exact or g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-7)


@pytest.mark.parametrize("form", list(FORMS))
def test_samplers_match_reference(monkeypatch, form):
    got, want = _tables(monkeypatch, form)
    exact = "float" in form
    uv, lod, mid = _uv_lod_mat()
    tu, tl, tm = (torch.from_numpy(a) for a in (uv, lod, mid))
    ju, jl, jm = (jnp.asarray(a) for a in (uv, lod, mid))
    _check(got.sample_combined(tm, tu, tl), want.sample_combined(jm, ju, jl), exact)
    _check(got.sample_alpha(tm, tu, tl), want.sample_alpha(jm, ju, jl), exact)
    # the texture stack and the mip table hold float texels in every form
    _check(got.sample_normal(tm, tu, tl), want.sample_normal(jm, ju, jl), True)
    _check(got.sample_normal(tm, tu), want.sample_normal(jm, ju), True)
    layer = np.random.default_rng(4).integers(-1, 4, len(uv)).astype(np.int32)
    _check(got.sample_texture(torch.from_numpy(layer), tu, tl),
           want.sample_texture(jnp.asarray(layer), ju, jl), True)
    _check(got.sample_texture(torch.from_numpy(layer), tu),
           want.sample_texture(jnp.asarray(layer), ju), True)
    _check(got.sample(tm, tu, tl), want.sample(jm, ju, jl), exact)
    _check(got.sample(tm, tu), want.sample(jm, ju), True)


def test_nearest_mip_and_clamp_state():
    """The nearest-mip form reads one level (round(lod)) and the clamp
    state holds the edge texel: a sample past the clamped map's right edge
    equals the edge texel's, where repeat wraps to the left edge."""
    table, images, meta = host_table()
    t = mat.MaterialTable.from_host(table, images, texture_size=S, sampler_meta=meta,
                                    device="cpu")
    uv = torch.tensor([[1.3, 0.5 / S], [0.5 / S, 0.5 / S]])
    lod = torch.zeros(2)
    a_clamp = t.sample_alpha(torch.tensor([2, 2]), uv, lod)  # material 2: clamped stripes
    assert torch.equal(a_clamp, torch.zeros(2))  # row 0's stripe is 0 at both
    layer = torch.tensor([1, 0])
    clamp = t.sample_texture(layer[:1], uv[:1])[0]
    assert torch.allclose(clamp, torch.from_numpy(images[1][0, -1]))
    rep = t.sample_texture(layer[1:], torch.tensor([[1.0 + 0.5 / S, 0.5 / S]]))[0]
    assert torch.allclose(rep, torch.from_numpy(images[0][0, 0]))
