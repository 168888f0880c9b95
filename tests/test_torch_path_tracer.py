"""The port's path tracer against the JAX package's, on the CPU.

Same numpy inputs, and for renders the same uniforms (drawn from the JAX
package's own key splits, ``jax_uniforms``), through both packages:
- scene build: the 48-column shading table, the sweep's arrays and the
  BVH8 table exactly equal; ``trace_scene_from_numpy`` carries the
  reference's scene across;
- lighting model: every function within 1e-6 * (1 + |ref|) on the same
  inputs (roughness 0.15..1, both NDFs), the half-vector samplers and the
  BRDF's pdfs within 1e-5 * (1 + |ref|) (float32 on both sides: sqrt, sin,
  cos, exp and log differ by an ulp or so, which sqrt(1 - cos^2) and the
  NDFs amplify);
- small functions exact: ``pixel_jitter``, ``rotate``, ``_swizzle_maps``,
  ``_morton10`` and ``_bounce_sort_key``;
- the slice as a whole: ``render`` at 32x32, 2 spp, 3 bounces on a plane
  and two 12x24 spheres, bounce sort and swizzle on. The ray count is
  equal and radiance within 1e-3 * (1 + |ref|) on >= 99% of pixels; once
  with default materials and once with a transmissive, scattering sphere
  (the volume path). A ray whose float32 arithmetic crosses an edge or a
  sort-key cell differently follows another path, hence the share;
- the textured scenes (``BUILDS``: each texture kind of the reference's
  texture tests on a plane, the material balls with procedural maps): the
  shading table, the mip and quad tables exactly equal; their renders, and
  the env-map sky's, are ``test_torch_trace_variants.py``'s;
- ``trace_rays`` on 3000 given rays (one partial ray block), bounce sort
  off as the reference's default: the same bounds on its radiance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import primitives as jax_primitives
from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.raytracing import bluenoise as jax_bn
from sailor_tpu.raytracing import lighting_model as jax_lm
from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.raytracing import bluenoise, lighting_model as lm, path_tracer as pt
from sailor_tpu_torch.raytracing import sweep
from sailor_tpu_torch.scenes import material_balls_soup, procedural_test_maps, tracer_soup
from test_torch_scenes import release_jax_executables  # noqa: F401

GLASS = {
    "albedo": np.asarray([[0.75, 0.75, 0.75], [0.9, 0.95, 1.0]], np.float32),
    "metallic": np.asarray([0.0, 0.0], np.float32),
    "roughness": np.asarray([0.6, 0.05], np.float32),
    "emissive": np.zeros((2, 3), np.float32),
    "transmission": np.asarray([0.0, 1.0], np.float32),
    "ior": np.asarray([1.5, 1.5], np.float32),
    "atten_color": np.asarray([[1, 1, 1], [0.5, 0.8, 0.9]], np.float32),
    "atten_dist": np.asarray([0.0, 1.0], np.float32),
    "scatter": np.asarray([0.0, 0.5], np.float32),
    "hg_g": np.asarray([0.0, 0.3], np.float32),
}


def _soup(materials):
    soup = tracer_soup(12, 24, 2)  # a plane and two 12x24 spheres
    if materials is GLASS:  # the second sphere is glass
        soup["material_id"][-(len(soup["material_id"]) - 2) // 2:] = 1
    return soup


def _carry(ref) -> pt.TraceScene:
    """The reference's TraceScene as the port's, array for array."""
    arrays = {k: None if getattr(ref, k) is None else np.asarray(getattr(ref, k))
              for k in pt.TRACE_KEYS + pt.OPTIONAL_KEYS}
    if not ref.has_textures:
        arrays["textures"] = None
    arrays["bvh_table"] = np.asarray(ref.bvh.table)
    sw = None
    if ref.sweep is not None:
        sw = {k: np.asarray(getattr(ref.sweep, k))
              for k in ("g_cluster", "v0e1e2", "tri_id", "cl_min", "cl_max")}
        sw["num_tris"] = ref.sweep.num_tris
    return pt.trace_scene_from_numpy(arrays, sw, ref.has_volumes, device="cpu",
                                     mip_sizes=ref.mip_sizes, quad_blocks=ref.quad_blocks,
                                     **{k: getattr(ref, k) for k in pt.FLAGS})


def _texture_plane(kind, mips=True):
    """The reference's texture tests' scene: a 10 m plane with one 8x8 map
    of ``kind`` (``tests/test_path_tracer.py:264-375``)."""
    soup = jax_primitives.merge([(jax_primitives.plane(10.0), np.eye(4))], material_ids=[0])
    mats = {"albedo": np.ones((1, 3), np.float32) * 0.8, "metallic": np.zeros(1, np.float32),
            "roughness": np.asarray([0.6], np.float32), "emissive": np.zeros((1, 3), np.float32),
            "texture_size": 8, f"{kind}_texture": np.asarray([0], np.int32)}
    tex = np.zeros((8, 8, 4), np.float32)
    if kind == "albedo":
        tex[:, :4], tex[:, 4:] = [1, 0, 0, 1], [0, 0, 1, 1]
    elif kind == "normal":
        # a strong tilt, as the reference's test has it, but off the
        # tangent axis: its [1, 0.5, 0.6] puts every shading normal on
        # z = 0, where the tangent basis of the BRDF sampler flips with the
        # sign of the last bit of n.z (ROADMAP C)
        tex[...] = [1.0, 0.7, 0.6, 1.0]
    elif kind == "orm":
        tex[...] = [1.0, 0.5, 1.0, 1.0]
        tex[:, 4:, 2] = 0.0              # metallic x0 on the right half
        mats["metallic"] = np.ones(1, np.float32)
    else:
        tex[:, :4, :3] = 1.0             # the left half emits
        mats["emissive"] = np.ones((1, 3), np.float32) * 2.0
    mats["images"] = [tex]
    return soup, mats


def _balls():
    soup, mats = material_balls_soup(8, 16)
    maps = procedural_test_maps(1, 32)
    for i, k in enumerate(("albedo", "normal", "orm", "emissive")):
        mats[f"{k}_texture"] = np.asarray([i] + [-1] * 8, np.int32)
    mats["emissive"][0] = 0.5
    mats.update(images=maps, texture_size=32)
    return soup, mats


BUILDS = {
    "default": lambda: (_soup(None), None),
    "glass": lambda: (_soup(GLASS), GLASS),
    "albedo_map": lambda: _texture_plane("albedo"),
    "normal_map": lambda: _texture_plane("normal"),
    "orm_map": lambda: _texture_plane("orm"),
    "emissive_map": lambda: _texture_plane("emissive"),
    "balls": _balls,
}


@pytest.mark.parametrize("materials", list(BUILDS))
def test_scene_from_mesh_matches_reference(materials):
    soup, mats = BUILDS[materials]()
    ref = jax_pt.scene_from_mesh(soup, mats)
    got = pt.scene_from_mesh(soup, mats, device="cpu")
    carried = _carry(ref)
    assert got.has_volumes == ref.has_volumes == (materials == "glass")
    for k in pt.FLAGS:
        assert getattr(got, k) == getattr(ref, k), k
    assert got.mip_sizes == ref.mip_sizes and got.quad_blocks == ref.quad_blocks
    for k in pt.TRACE_KEYS + ("tex_lod", "tex_quad"):
        if getattr(ref, k) is None:
            assert getattr(got, k) is None, k
            continue
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)), k)
        assert torch.equal(getattr(carried, k), getattr(got, k))
    if ref.has_textures:
        np.testing.assert_array_equal(got.textures.numpy(), np.asarray(ref.textures))
    for k in ("g_cluster", "v0e1e2", "tri_id", "cl_min", "cl_max"):
        assert torch.equal(getattr(carried.sweep, k), getattr(got.sweep, k)), k
    assert got.sweep.n_clusters == ref.sweep.n_clusters
    np.testing.assert_array_equal(got.bvh.table.numpy().view(np.int32),
                                  np.asarray(ref.bvh.table).view(np.int32))
    assert torch.equal(carried.bvh.table.view(torch.int32), got.bvh.table.view(torch.int32))
    assert got.bvh.num_tris == ref.bvh.num_tris


def _lighting_inputs(n=4096):
    rng = np.random.default_rng(3)
    f = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((wo * nrm).sum(1, keepdims=True) < 0, -wo, wo)
    wi = rng.normal(size=(n, 3)).astype(np.float32) + nrm
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    h = wo + wi
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    return dict(n=nrm, wo=wo, wi=wi, h=h, u1=f(n), u2=f(n), rough=0.15 + 0.85 * f(n),
                albedo=f(n, 3), metal=f(n), eta=0.5 + f(n), g=f(n) * 1.8 - 0.9,
                cos=f(n) * 2 - 1, pa=f(n), pb=f(n))


# sin = sqrt(1 - cos^2) near cos = 1, and the NDF behind the BRDF's pdf,
# turn an ulp of a transcendental into a few 1e-6
LIGHTING_TOL = {"ggx_half": 1e-5, "beckmann_half": 1e-5, "spec_half": 1e-5, "brdf": 1e-5}


def _lighting_calls(mod, m3, x):
    """Every lighting-model function on the inputs ``x`` of one package."""
    h = x["h"]
    tb = mod.tangent_basis(x["n"])
    refr, tir = mod.refract(-x["wo"], x["n"], x["eta"])
    return {
        "cosine": mod.sample_cosine_hemisphere(x["n"], x["u1"], x["u2"]),
        "ggx_half": mod.sample_ggx_half(x["n"], x["rough"], x["u1"], x["u2"]),
        "beckmann_half": mod.sample_beckmann_half(x["n"], x["rough"], x["u1"], x["u2"]),
        "spec_half": mod.sample_spec_half(x["n"], x["rough"], x["u1"], x["u2"]),
        "reflect": m3.reflect(-x["wo"], h),
        "ggx_pdf": mod.ggx_pdf(x["n"], h, x["wo"], x["rough"]),
        "beckmann_pdf": mod.beckmann_pdf(x["n"], h, x["wo"], x["rough"]),
        "ndf_beckmann": mod.ndf_beckmann(x["cos"], x["rough"]),
        "brdf": mod.eval_brdf(x["n"], x["wo"], x["wi"], x["albedo"], x["metal"], x["rough"]),
        "tangent_basis": tb,
        "to_world": mod.to_world(x["n"], x["wo"]),
        "refract": (refr, tir),
        "fresnel": mod.fresnel_dielectric(abs(x["cos"]), x["eta"]),
        "hg_phase": mod.hg_phase(x["cos"], x["g"]),
        "sample_hg": mod.sample_hg(x["wo"], x["g"], x["u1"], x["u2"]),
        "power_heuristic": mod.power_heuristic(x["pa"], x["pb"]),
    }


def test_lighting_model_matches_reference():
    x = _lighting_inputs()
    want = _lighting_calls(jax_lm, jax_m3, {k: jnp.asarray(v) for k, v in x.items()})
    got = _lighting_calls(lm, m3, {k: torch.from_numpy(v) for k, v in x.items()})
    for name in want:
        w = jax.tree_util.tree_leaves(want[name])
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        assert len(w) == len(g), name
        for a, b in zip(w, g):
            a, b = np.asarray(a), b.numpy()
            if a.dtype == bool:
                np.testing.assert_array_equal(b, a, name)
            else:
                assert np.isfinite(a).all(), name
                err = np.abs(b - a) / (1 + np.abs(a))
                assert err.max() <= LIGHTING_TOL.get(name, 1e-6), (name, err.max())


@pytest.mark.parametrize("size", [(32, 32), (48, 80), (512, 512), (100, 37)])
def test_swizzle_maps_and_jitter_exact(size):
    h, w = size
    want = jax_pt._swizzle_maps(h, w, 2048, 256)
    got = pt._swizzle_maps(h, w, sweep.RAY_BLOCK, sweep.SUB)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jax_bn.pixel_jitter(h, w), bluenoise.pixel_jitter(h, w)):
        np.testing.assert_array_equal(b, a)


def test_rotate_morton_and_sort_key_exact():
    rng = np.random.default_rng(4)
    base = rng.random((2, 5000)).astype(np.float32)
    for s in (0.0, 1.0, 7.0, 63.0):
        want = jax_bn.rotate((jnp.asarray(base[0]), jnp.asarray(base[1])), s)
        got = bluenoise.rotate((torch.from_numpy(base[0]), torch.from_numpy(base[1])), s)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = rng.integers(0, 1 << 12, 5000).astype(np.int32)
    np.testing.assert_array_equal(pt._morton10(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_pt._morton10(jnp.asarray(x))))
    soup = _soup(None)
    ref = jax_pt.scene_from_mesh(soup)
    scene = _carry(ref)
    o = rng.uniform([-21, -0.5, -21], [21, 2.5, 21], (5000, 3)).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    live = rng.random(5000) > 0.2
    want = np.asarray(jax_pt._bounce_sort_key(ref, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(live)))
    got = pt._bounce_sort_key(scene, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(live)).numpy()
    np.testing.assert_array_equal(got, want)


def jax_uniforms(key, spp: int, bounces: int, r: int, sample_batch: int = 1) -> np.ndarray:
    """(spp / sb, 5 * bounces, sb * r) uniforms as the reference's render
    draws them: one key per sample, of which each pass of sb samples uses
    its first; 5 * bounces keys a pass, uniform(k, (sb * r,))."""
    sb = sample_batch
    keys = jax.random.split(key, spp).reshape(spp // sb, sb, -1)
    return np.stack([
        np.stack([np.asarray(jax.random.uniform(k, (sb * r,)))
                  for k in jax.random.split(sk[0], 5 * bounces)])
        for sk in keys])


@pytest.mark.parametrize("materials", [None, GLASS], ids=["default", "glass"])
def test_render_matches_reference(materials):
    w = h = 32
    spp, bounces = 2, 3
    ref = jax_pt.scene_from_mesh(_soup(materials), materials)
    cam = jnp.asarray([0.0, 4.0, 9.0])
    view = jax_m3.look_at(cam, jnp.asarray([0.0, 0.6, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 100.0)
    key = jax.random.PRNGKey(3)
    want, want_rays = jax_pt.render(ref, cam, view, proj, width=w, height=h, spp=spp,
                                    max_bounces=bounces, key=key, sort_bounces=True,
                                    swizzle=True)
    uniforms = jax_uniforms(key, spp, bounces, pt.rays_per_sample(w, h))
    got, rays = pt.render(_carry(ref), *(torch.from_numpy(np.array(a)) for a in (cam, view, proj)),
                          width=w, height=h, spp=spp, max_bounces=bounces,
                          uniforms=torch.from_numpy(uniforms), sort_bounces=True)
    want = np.asarray(want)
    assert float(rays) == float(want_rays) > 2 * w * h * spp
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    assert close.mean() >= 0.99, close.mean()


def test_trace_rays_matches_reference():
    spp, bounces, r = 2, 3, 3000
    ref = jax_pt.scene_from_mesh(_soup(None))
    rng = np.random.default_rng(8)
    target = rng.uniform([-4, 0, -3], [4, 2, 3], (r, 3))
    o = np.tile(np.float32([[0.0, 4.0, 9.0]]), (r, 1))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    key = jax.random.PRNGKey(5)
    want, want_rays = jax_pt.trace_rays(ref, jnp.asarray(o), jnp.asarray(d), spp=spp,
                                        max_bounces=bounces, key=key)
    got, rays = pt.trace_rays(_carry(ref), torch.from_numpy(o), torch.from_numpy(d),
                              spp=spp, max_bounces=bounces,
                              uniforms=torch.from_numpy(jax_uniforms(key, spp, bounces, r)))
    want = np.asarray(want)
    assert float(rays) == float(want_rays) > 2 * r * spp
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    assert close.mean() >= 0.99, close.mean()

