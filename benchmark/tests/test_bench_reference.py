"""The plain reference against the port's CPU path at a tiny size: the
same inputs from the cells' own scene recipes, the port's plain twins on
one side and the reference on the other."""

import numpy as np
import pytest
import torch
from conftest import small

from benchmark.harness import manifest
from benchmark.reference import light_cull, raster, shade, tonemap, tracer


def _session(workload, seed=3):
    c = manifest.cell(workload)
    for k, v in small(workload).items():
        (c.traffic if k == "traffic" else c.config[k]).update(v)
    drv = c.driver()
    s = drv.setup(c, seed, "cpu")
    drv.window_run(s, 0.0)
    return c, s


@pytest.fixture(scope="module")
def frame():
    return _session("queues-1080p.still")


@pytest.fixture(scope="module")
def render():
    return _session("tracer-512.pooled")


def test_raster_agrees_with_the_port(frame):
    _, s = frame
    depth, src, cond = raster.rasterize(s.host)
    tid = s.capture["tid"]
    src_p = torch.where(tid >= 0, s.capture["src"].long()[tid.clamp(min=0).long()], -1)
    assert float(((src >= 0) != (src_p >= 0)).float().mean()) < 5e-3
    both = (src >= 0) & (src_p >= 0)
    close = (depth - s.capture["depth"]).abs() <= 1e-4 * depth.abs() + 4 * cond + 1e-7
    assert float((both & ~close).float().mean()) < 5e-3


def test_transparent_layers_agree_with_the_port(frame):
    """The reference's two-sided peel, nearest layer first, against the
    layer G-buffers RenderTransparent shaded (farthest first)."""
    _, s = frame
    depth, _, _ = raster.rasterize(s.host)
    layers = raster.transparent_layers(s.host, depth, 3)
    assert sum(int((src >= 0).sum()) for src, _ in layers) > 0
    for (src, _), (gb, _) in zip(layers, reversed(s.capture["t_layers"])):
        h, w = src.shape
        cov = gb.coverage[:h, :w] > 0.5
        assert torch.equal(cov, src >= 0)
        # the winner may be either of two triangles whose shared edge the
        # coverage margin admits: both points lie near that edge, within a
        # pixel's 0.05 margin (0.5 m wide pixels at this size)
        pos = raster.position(s.host, src)[cov]
        dist = torch.linalg.vector_norm(pos - torch.from_numpy(s.host["eye"]), dim=-1)
        gap = torch.linalg.vector_norm(gb.world_position[:h, :w][cov] - pos, dim=-1)
        assert bool((gap <= 2e-3 * dist).all()), float((gap / dist).max())


def test_masked_alpha_levels_follow_the_texture_format():
    """Box-filtered halvings to 4 texels, each stored as 8-bit sRGB."""
    a = np.zeros((16, 16), np.float32)
    a[:, ::2] = 1.0
    levels = raster.alpha_levels(a, torch.float32, "cpu")
    assert [lv.shape[0] for lv in levels] == [16, 8, 4]
    assert torch.equal(levels[0], torch.from_numpy(a))
    # 0.5 is stored as round(0.5 ** (1 / 2.2) * 255) = 186, which reads below 0.5
    assert torch.allclose(levels[1], torch.full((8, 8), (186 / 255) ** 2.2))
    assert float(levels[1][0, 0]) < 0.5


def test_aabb_pairs_count_each_box(frame):
    _, s = frame
    t = raster.setup(s.host, (0,), True)
    x0, x1, y0, y1 = raster.pixel_boxes(t, s.host["width"], s.host["height"])
    brute = sum(max(0, int(b) - int(a) + 1) * max(0, int(d) - int(c) + 1)
                for a, b, c, d in zip(x0, x1, y0, y1))
    assert raster.aabb_pairs(t, s.host["width"], s.host["height"]) == brute


def test_light_lists_equal_the_port(frame):
    from sailor_tpu_torch.kernels import light_culling

    c, s = frame
    h = s.host
    lin = light_cull.linearize(s.capture["depth"], h["z_near"], h["z_far"])
    lights = {k: torch.from_numpy(v) for k, v in h["lights"].items()}
    inv_proj = torch.from_numpy(np.linalg.inv(h["proj"].astype(np.float64)).astype(np.float32))
    kw = dict(tiles_y=h["height"] // 16, tiles_x=h["width"] // 16,
              viewport=(h["width"], h["height"]), max_per_tile=128, coarse_capacity=16)
    ref, _ = light_cull.cull(lights, torch.from_numpy(h["view"]), inv_proj, lin, **kw)
    from sailor_tpu_torch.kernels.lights import Lights

    lt = h["lights"]
    pl = Lights.from_host(types=list(lt["type"]), positions=lt["position"],
                          directions=lt["direction"], intensities=lt["intensity"],
                          attenuations=lt["attenuation"], radii=list(lt["radius"]), device="cpu")
    got, _ = light_culling.cull_lights(pl, torch.from_numpy(h["view"]), inv_proj, lin, **kw)
    assert float((got != ref).float().mean()) < 1e-3


def test_shade_and_tonemap_follow_the_port(frame):
    from benchmark.checks import frame_stages

    c, s = frame
    numbers = frame_stages.judge(s.capture, s.host, "cpu", c.config["settings"])
    assert numbers["shade_gap"] < 1e-5
    assert numbers["transparent_px_off"] == 0.0
    assert numbers["final_gap"] < 1e-6
    assert numbers["light_list_off"] == 0.0


def test_intersect_agrees_with_the_port(render):
    from sailor_tpu_torch.raytracing import sweep

    _, s = render
    scene = s.program[0]
    tri = tracer.triangles(s.host)
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([0.0, 4.0, 9.0]).expand(512, 3) + torch.randn(512, 3, generator=g) * 0.1
    d = torch.nn.functional.normalize(torch.randn(512, 3, generator=g) * 0.3
                                      + torch.tensor([0.0, -0.4, -1.0]), dim=-1)
    ref = tracer.intersect(tri, o, d)
    got = sweep.intersect(scene.sweep, o, d)
    assert torch.equal(ref["hit"], got["hit"])
    assert torch.allclose(ref["t"][ref["hit"]], got["t"][got["hit"]], rtol=1e-5)


def test_traced_slots_follow_the_port(render):
    from benchmark.checks import trace_stages

    c, s = render
    numbers = trace_stages.judge(s.capture, s.host, "cpu", {})
    assert numbers == {"isect_t_off": 0.0, "isect_any_off": 0.0, "image_px_off": 0.0,
                       "sort_key_off": 0.0}


def test_swizzle_owners_cover_every_pixel():
    perm, owner, n = tracer.swizzle(40, 24, 2048, 256)
    assert n >= 40 * 24 and sorted(perm[owner].tolist()) == list(range(40 * 24))


def test_shade_matches_the_port_plain_shade():
    from sailor_tpu_torch.kernels import pbr
    from sailor_tpu_torch.kernels.lights import Lights

    g = torch.Generator().manual_seed(1)
    h, w, n = 32, 48, 9

    def r(*shape):
        return torch.rand(*shape, generator=g)

    gb = {"world_position": r(h, w, 3) * 10, "normal": torch.nn.functional.normalize(
        r(h, w, 3) - 0.5, dim=-1), "albedo": r(h, w, 4), "metallic": r(h, w),
        "roughness": r(h, w) * 0.9 + 0.05, "ao": r(h, w), "emissive": r(h, w, 3) * 0.1,
        "coverage": (r(h, w) > 0.2).float()}
    lt = {"type": np.array([0] + [1] * (n - 1), np.int32),
          "position": (np.random.default_rng(2).random((n, 3)) * 10).astype(np.float32),
          "direction": np.tile(np.array([[0.3, -0.9, 0.2]], np.float32), (n, 1)),
          "intensity": np.ones((n, 3), np.float32) * 3, "attenuation": np.tile(
              np.array([[1, 0, 0.8]], np.float32), (n, 1)),
          "radius": np.full(n, 6.0, np.float32), "cutoff": np.zeros((n, 2), np.float32)}
    idx = torch.randint(-1, n, (h // 16, w // 16, 8), generator=g, dtype=torch.int32)
    cam = torch.tensor([1.0, 5.0, 12.0])
    ref = shade.shade(gb, {k: torch.from_numpy(v) for k, v in lt.items()}, idx, cam)
    pl = Lights.from_host(types=list(lt["type"]), positions=lt["position"],
                          directions=lt["direction"], intensities=lt["intensity"],
                          attenuations=lt["attenuation"], radii=list(lt["radius"]), device="cpu")
    got = pbr.shade_forward_plus(pbr.GBuffer(**gb), pl, idx, cam)
    # float32 with the operations in another order: a few ulps a term
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_tonemap_matches_the_port():
    from sailor_tpu_torch.kernels import histogram, tonemap as tm
    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.raytracing.bluenoise import blue_noise_mask

    hdr = torch.rand(64, 128, 3, generator=torch.Generator().manual_seed(4)) * 4
    prev = torch.tensor(0.3)
    avg = tonemap.average_luminance(hdr, prev, 1 / 60 + 0.25, 1.1)
    q = hdr.reshape(16, 4, 32, 4, 3).sum(dim=(1, 3)) / 16
    avg_p = histogram.adapt_average_luminance(histogram.luminance_histogram(q), prev, 512.0,
                                              torch.tensor(1 / 60 + 0.25), tau=1.1)
    assert torch.allclose(avg, avg_p, rtol=1e-6)
    srgb = m3.linear_to_srgb(tm.tonemap(hdr, avg_p, mode="aces"))
    bn = torch.from_numpy(blue_noise_mask(64)).tile(2, 2)[:64, :128]
    got = torch.clamp(srgb + (bn[..., None] - 0.5) / 255.0, 0, 1)
    assert torch.allclose(tonemap.final(hdr, avg_p), got, atol=1e-6)
