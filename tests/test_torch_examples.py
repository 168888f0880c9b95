"""The port's examples (sailor_tpu_torch/examples/render_frame.py and
trace.py) against the JAX package's examples/, on the CPU.

render_frame: the reference example runs once for the module as a
subprocess (``SAILOR_AOT_CACHE=0`` in its environment: its process turns
the AOT cache on, which breaks on XLA:CPU, ROADMAP "Faults in the JAX
package") at 128x96 with 8 lights and 1 timed frame; the port's
``main(["--cpu", ...])`` renders the same and both PNGs are decoded:
- as run: >= 99.8% of the pixel channels within 3 levels (Final's 2/255
  bar of tests/test_torch_frame_full.py plus 1 for the truncation to
  uint8) and the mean within 0.1 level. Measured: 0.79% of the channels
  differ, 0.06% by more than 1 level, at most 17, all at triangle edges:
  the reference builds the camera op by op, so one entry of its view
  matrix differs from the port's (fused, as the reference's compiled
  code) by 1 ulp and a few edge pixels pick another triangle;
- with the reference's view matrix carried into the port's scene: every
  channel within 3 levels (measured: at most 1, on 0.008%).

trace: the example's scene (ground, eight balls; also with ``--ambient``,
``--sky`` and ``--gltf`` on a GLB the test writes) equal to what
examples/trace.py:55-89 builds with the reference (shading table, sweep,
texture stacks and BVH8 table bit for bit, ``num_triangles``; the sky's
environment bake at the default 128x256 within 1e-4 * (1 + |ref|),
measured 5.05e-5: tests/test_torch_sky.py holds the same bake at 16x32
within 5e-5). With ``--gltf`` both load the model's images, which the reference
example leaves out (its textured materials then gather from an empty
stack); its render at 32x32, 2
spp, 2 bounces with the uniforms the reference draws from its key 2,
radiance within 1e-3 * (1 + |ref|) on >= 99% of pixels as
tests/test_torch_path_tracer.py holds renders; the PNG conversion equal
to the reference's on that image; ``main(["--cpu", ...])`` end to end,
with ``--gltf`` and with ``--sky``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.assets import primitives as jax_primitives
from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.kernels import tonemap as jax_tonemap
from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu_torch.examples import render_frame, trace
from sailor_tpu_torch.raytracing import path_tracer as pt
from sailor_tpu_torch.rhi.types import FrameData
from sailor_tpu_torch.utils.png import decode_png
from test_torch_path_tracer import jax_uniforms
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_ARGS = ["--width", "128", "--height", "96", "--lights", "8", "--frames", "1"]


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.int32)


# --- trace ---------------------------------------------------------------------------


def _args(*argv):
    return trace.parse_args(["--cpu", *argv])


def _reference_scene(args):
    """examples/trace.py:55-89 with the JAX package."""
    if args.gltf:
        from sailor_tpu.assets import gltf

        soup, materials = gltf.load_merged(args.gltf)
        materials = dict(materials, images=gltf.GLTF.load(args.gltf).load_texture_images())
    else:
        meshes = [(jax_primitives.plane(40.0), np.eye(4))]
        mats = {"albedo": [[0.65, 0.65, 0.65]], "metallic": [0.0],
                "roughness": [0.7], "emissive": [[0, 0, 0]]}
        mat_ids = [0]
        k = 1
        for i, metallic in enumerate((0.0, 1.0)):
            for j, rough in enumerate((0.08, 0.3, 0.6, 0.9)):
                t = np.eye(4)
                t[:3, 3] = [(j - 1.5) * 2.2, 0.9, (i - 0.5) * 2.4]
                meshes.append((jax_primitives.uv_sphere(0.9, 24, 48), t))
                mats["albedo"].append([0.8, 0.35, 0.25] if metallic < 0.5
                                      else [0.95, 0.78, 0.45])
                mats["metallic"].append(metallic)
                mats["roughness"].append(rough)
                mats["emissive"].append([0, 0, 0])
                mat_ids.append(k)
                k += 1
        soup = jax_primitives.merge(meshes, mat_ids)
        materials = {k2: np.asarray(v, np.float32) for k2, v in mats.items()}
    sky_kw = {}
    if args.ambient is not None:
        sky_kw = {"sky_zenith": args.ambient, "sky_horizon": args.ambient}
    if args.sky:
        from sailor_tpu.kernels.sky import SkyParams

        sky_kw["sky"] = SkyParams.default()
    return jax_pt.scene_from_mesh(soup, materials, **sky_kw)


@pytest.fixture(scope="module")
def glb_path(tmp_path_factory):
    sys.path.insert(0, REPO)
    import chip_smoke
    from sailor_tpu_torch.scenes import procedural_test_maps

    path = tmp_path_factory.mktemp("glb") / "balls.glb"
    path.write_bytes(chip_smoke.balls_glb(procedural_test_maps(0, 16), 8, 16))
    return str(path)


@pytest.mark.parametrize("case", ["default", "ambient", "sky", "gltf"])
def test_trace_scene_matches_reference(case, glb_path):
    argv = {"default": [], "ambient": ["--ambient", "0.2", "0.3", "0.4"], "sky": ["--sky"],
            "gltf": ["--gltf", glb_path]}[case]
    args = _args(*argv)
    got = trace.build_scene(args, "cpu")
    ref = _reference_scene(args)
    assert got.num_triangles == ref.num_triangles == (18434 if case != "gltf" else 2050)
    for k in pt.TRACE_KEYS + pt.OPTIONAL_KEYS:
        if getattr(ref, k) is None:
            assert getattr(got, k) is None, k
        elif k == "env_map":
            want = np.asarray(ref.env_map)
            assert (np.abs(got.env_map.numpy() - want) / (1 + np.abs(want))).max() <= 1e-4
        else:
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                          k)
    for k in pt.FLAGS:
        assert getattr(got, k) == getattr(ref, k), k
    for k in ("g_cluster", "v0e1e2", "tri_id", "cl_min", "cl_max"):
        np.testing.assert_array_equal(getattr(got.sweep, k).numpy(),
                                      np.asarray(getattr(ref.sweep, k)), k)
    np.testing.assert_array_equal(got.bvh.table.numpy().view(np.int32),
                                  np.asarray(ref.bvh.table).view(np.int32))


def test_trace_render_matches_reference():
    w = h = 32
    spp, bounces = 2, 2
    args = _args()
    ref_scene = _reference_scene(args)
    cam = jnp.asarray(args.camera)
    view = jax_m3.look_at(cam, jnp.asarray(args.target), jnp.asarray([0.0, 1.0, 0.0]))
    proj = jax_m3.perspective(jnp.pi / 4, w / h, 0.1, 100.0)
    key = jax.random.PRNGKey(2)
    want, want_rays = jax_pt.render_cached(ref_scene, cam, view, proj, width=w, height=h,
                                           spp=spp, max_bounces=bounces, key=key)
    want = np.asarray(want)
    scene = trace.build_scene(args, "cpu")
    cam_t, view_t, proj_t = trace.camera(args, "cpu")
    np.testing.assert_array_equal(proj_t.numpy(), np.asarray(proj))
    uniforms = jax_uniforms(key, spp, bounces, pt.rays_per_sample(w, h))
    got, rays = pt.render_cached(scene, cam_t, view_t, proj_t, width=w, height=h, spp=spp,
                                 max_bounces=bounces, uniforms=torch.from_numpy(uniforms))
    assert float(rays) == float(want_rays) > 2 * w * h * spp
    close = np.abs(got.numpy() - want).max(-1) <= 1e-3 * (1 + np.abs(want).max(-1))
    assert close.mean() >= 0.99, close.mean()
    # the example's PNG conversion on the reference's image, against the reference's
    ldr = jax_tonemap.tonemap(jnp.asarray(want), avg_luminance=float(want.mean()) * 0.6,
                              mode="aces")
    want_u8 = np.asarray(jax_m3.linear_to_srgb(ldr) * 255).astype(np.uint8)
    got_u8 = decode_png(trace.to_png(torch.from_numpy(want)))
    assert np.abs(got_u8.astype(int) - want_u8).max() <= 1


@pytest.mark.parametrize("extra", [[], ["--sky", "--ambient", "0.1", "0.1", "0.1"], "gltf"],
                         ids=["balls", "sky", "gltf"])
def test_trace_main_end_to_end(extra, glb_path, tmp_path, capsys):
    if extra == "gltf":
        extra = ["--gltf", glb_path]
    out = str(tmp_path / "trace.png")
    assert trace.main(["--cpu", "--size", "16", "--spp", "1", "--bounces", "2", "--out", out,
                       *extra]) == 0
    text = capsys.readouterr().out
    tris = 18434 if "--gltf" not in extra else 2050
    assert f"({tris} tris)" in text and "Mrays/s" in text
    img = _png(out)
    assert img.shape == (16, 16, 3) and img.std() > 1


# --- render_frame (last: the reference example runs meanwhile) ---------------


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference example, started when the module starts so that it runs
    beside the trace tests (which come first in this file)."""
    out = str(tmp_path_factory.mktemp("ref") / "frame.png")
    env = dict(os.environ, SAILOR_AOT_CACHE="0", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "examples", "render_frame.py"),
                             *FRAME_ARGS, "--out", out], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_frame(reference_run):
    proc, out = reference_run
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-2000:]
    assert "overflow=0" in stdout
    return _png(out)


def test_render_frame_png_matches_reference(reference_frame, tmp_path, capsys):
    out = str(tmp_path / "frame.png")
    assert render_frame.main(["--cpu", *FRAME_ARGS, "--out", out]) == 0
    text = capsys.readouterr().out
    assert "scene: 3514 verts, 6218 tris" in text and "overflow=0" in text
    got = _png(out)
    assert got.shape == reference_frame.shape == (96, 128, 3)
    diff = np.abs(got - reference_frame)
    assert (diff <= 3).mean() >= 0.998 and diff.mean() < 0.1, (diff.max(), (diff > 3).mean())


def test_render_frame_with_reference_camera(reference_frame, tmp_path, monkeypatch):
    cam = jnp.asarray([10.0, 6.0, 12.0])
    view = np.array(jax_m3.look_at(cam, jnp.asarray([0.0, 0.5, 0.0]),
                                   jnp.asarray([0.0, 1.0, 0.0])))
    build = render_frame.build_scene

    def with_reference_view(*args):
        scene = build(*args)
        f = scene.frame
        return dataclasses.replace(scene, frame=FrameData.create(
            torch.from_numpy(view), f.projection, f.camera_position, 0.1, 100.0, dt=1 / 60))

    monkeypatch.setattr(render_frame, "build_scene", with_reference_view)
    out = str(tmp_path / "frame.png")
    assert render_frame.main(["--cpu", *FRAME_ARGS, "--out", out]) == 0
    assert np.abs(_png(out) - reference_frame).max() <= 3
