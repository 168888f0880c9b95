"""The port's path tracer against the reference's golden image, on the CPU.

tests/test_golden.py's ``tracer`` scene (a 20 m plane and a 0.8 m sphere,
96x96, 16 spp, 3 bounces, ``jax.random.PRNGKey(7)``) rendered by the port's
``path_tracer.render`` with the reference's uniforms (drawn from the same
key as its render draws them, test_torch_path_tracer.py's
``jax_uniforms``), tonemapped as test_golden does (clip, sRGB, 8 bits) and
held to tests/golden/tracer.png at test_golden's bar: mean difference
< 2.5/255 and 99th percentile < 12/255.
"""

import os

import jax
import numpy as np
import torch

from sailor_tpu_torch.assets import primitives
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.raytracing import path_tracer as pt
from test_golden import GOLDEN_DIR, _to_u8, load_png
from test_torch_path_tracer import jax_uniforms
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)


def render_tracer():
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.0, 0.8, 0.0]
    soup = primitives.merge([(primitives.plane(20.0), np.eye(4)),
                             (primitives.uv_sphere(0.8), t)])
    scene = pt.scene_from_mesh(soup, device="cpu")
    cam = torch.tensor([2.5, 2.0, 3.5])
    view = m3.look_at(cam, torch.tensor([0.0, 0.6, 0.0]), torch.tensor([0.0, 1.0, 0.0]))
    proj = m3.perspective(np.pi / 3, 1.0, 0.1, 50.0)
    spp, bounces = 16, 3
    uniforms = jax_uniforms(jax.random.PRNGKey(7), spp, bounces, pt.rays_per_sample(96, 96))
    img, _ = pt.render(scene, cam, view, proj, width=96, height=96, spp=spp,
                       max_bounces=bounces, uniforms=torch.from_numpy(uniforms))
    return _to_u8(m3.linear_to_srgb(torch.clamp(img, 0.0, 1.0)).numpy())


def test_golden_tracer():
    ref = load_png(os.path.join(GOLDEN_DIR, "tracer.png")).astype(np.float32)
    got = render_tracer().astype(np.float32)
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.mean() < 2.5, diff.mean()
    assert np.percentile(diff, 99) < 12, (np.percentile(diff, 99), diff.max())
