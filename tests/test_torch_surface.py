"""The reference's public surface in the port.

``test_every_public_name_has_a_counterpart`` walks both packages with
``ast``: every public module-level name and public method of a class in
``sailor_tpu`` has a counterpart of the same name in the same-named module
of ``sailor_tpu_torch``, and every argument of a reference function is an
argument of the port's. ``EXCEPTIONS`` lists what the port leaves out, each
with its reason: ROADMAP A 10's TPU-only items, the arguments the port
replaces by its own idiom (a JAX key by a torch generator or uniforms, a
mesh axis by the port's shard arguments).

The names the port gained last are then held to the reference: the
``config`` constants and ``RenderConfig``, the shadow types,
``geometry_smith``, ``direct_lighting``, ``perspective(reverse_z=False)``,
``camera_rays_flat``, ``Mesh.num_vertices``/``num_triangles`` and
``native_bridge.bvh8_build``; ``native_bridge.load`` raises on a failed
build, where the reference's falls back.
"""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A10 = "ROADMAP A 10, not ported: "
EXCEPTIONS = {
    # whole modules
    "assets.aot_cache": A10 + "the XLA executable cache",
    "assets.shader_cache": A10 + "the XLA side of the compilation cache",
    "kernels.pbr_pallas": A10 + "B3's Pallas file; its port is csrc/shade.cu with "
                                "kernels/pbr_kernel.py",
    # names
    "assets.materials.pack_u8_rows": A10 + "the port's (R, C) uint8 rows stand for it",
    "config.on_tpu": A10 + "a TPU backend query",
    "config.interpret_pallas": A10 + "Pallas's interpret mode",
    "framegraph.graph.FrameGraph.process_pernode": A10 + "a jit strategy (profile_frame's "
                                                         "--pernode) the eager port has not",
    "kernels.common.pallas_call": A10 + "the interpret fallback of pallas_call",
    "kernels.common.pad_to": A10 + "a TPU padding helper",
    "kernels.common.pad_axis": A10 + "a TPU padding helper",
    "kernels.common.kernel_permutation": A10 + "an XLA jit-cache key; the port's kernels "
                                               "are keyed by their build's hash",
    "kernels.common.image_hw": A10 + "an XLA jit-cache helper",
    "native_bridge.load(build)": A10 + "build=False is the reference's fallback to "
                                       "Python; the port builds and raises, never falls back",
    "raytracing.sweep.FUSED_SLAB": A10 + "the SAILOR_SWEEP_FUSED_SLAB=0 XLA A/B knob",
    # arguments
    "kernels.blur.blur_rows_sharded(axis_name, n_shards)": "a JAX mesh axis; the port's "
                                                           "shard arguments stand for it",
    "kernels.postprocess.exchange_row_halo(axis_name, n_shards)": "a JAX mesh axis",
    "kernels.postprocess.hbao_sharded(axis_name, n_shards)": "a JAX mesh axis",
    "kernels.postprocess.motion_blur(axis_name, n_shards)": "a JAX mesh axis",
    "kernels.postprocess.sun_shafts(axis_name, n_shards)": "a JAX mesh axis",
    "kernels.sampling.upsample_bilinear_pow2_sharded(axis_name, n_shards)": "a JAX mesh axis",
    "parallel.mesh.sharded_path_trace(key)": "a JAX PRNG key; the port takes a seed",
    "raytracing.path_tracer.trace_rays(key)": "a JAX PRNG key; the port takes uniforms",
    "raytracing.path_tracer.render(key)": "a JAX PRNG key; the port takes a seed or uniforms",
    "raytracing.path_tracer.render_cached(key)": "a JAX PRNG key; the port takes a seed",
}


def _surface(package):
    """{module: {name: argument names, or None for a class or a value}},
    public names only, methods as ``Class.method``."""
    root = os.path.join(REPO, package)
    out = {}
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            module = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            names = {}
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names[node.name] = [a.arg for a in node.args.args + node.args.kwonlyargs]
                elif isinstance(node, ast.ClassDef):
                    names[node.name] = None
                    for b in node.body:
                        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            names[f"{node.name}.{b.name}"] = [
                                a.arg for a in b.args.args + b.args.kwonlyargs]
                elif isinstance(node, ast.Assign):
                    names.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
                elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                    names[node.target.id] = None
            out[module] = {k: v for k, v in names.items()
                           if not k.split(".")[-1].startswith("_")}
    return out


def test_every_public_name_has_a_counterpart():
    ref, port = _surface("sailor_tpu"), _surface("sailor_tpu_torch")
    missing = []
    for module, names in sorted(ref.items()):
        if module in EXCEPTIONS:
            assert module not in port, f"{module} is ported: drop its exception"
            continue
        assert module in port, f"sailor_tpu_torch has no module {module}"
        for name, args in names.items():
            key = f"{module}.{name}"
            if name not in port[module]:
                missing.append(key)
            elif args is not None and port[module][name] is not None:
                lost = [a for a in args if a not in port[module][name]]
                if lost:
                    missing.append(f"{key}({', '.join(lost)})")
    assert sorted(missing) == sorted(EXCEPTIONS.keys() - {
        m for m in EXCEPTIONS if m in ref}), sorted(set(missing) ^ set(EXCEPTIONS))


def test_config_constants_and_render_config_match_reference():
    from sailor_tpu import config as j_config
    from sailor_tpu_torch import config

    for name in ("LIGHTS_CULLING_TILE_SIZE", "LIGHTS_CANDIDATES_PER_TILE", "LIGHTS_PER_TILE",
                 "MAX_LIGHTS", "NUM_CSM_CASCADES", "SHADOW_CASCADE_LEVELS", "CSM_RESOLUTION",
                 "EVSM_C1", "EVSM_C2", "GPU_CULLING_GROUP_SIZE", "RGB_TO_LUM"):
        assert getattr(config, name) == getattr(j_config, name), name
    fields = [(f.name, f.default) for f in dataclasses.fields(config.RenderConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(j_config.RenderConfig)]
    for kw in ({}, {"width": 1000, "height": 17}, {"width": 16, "height": 33}):
        got, want = config.RenderConfig(**kw), j_config.RenderConfig(**kw)
        assert (got.num_tiles_x, got.num_tiles_y) == (want.num_tiles_x, want.num_tiles_y)
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.RenderConfig().width = 2


def test_shadow_types_match_reference():
    from sailor_tpu.kernels import lights as j_lights
    from sailor_tpu_torch.kernels import lights

    for name in ("SHADOW_NONE", "SHADOW_PCF", "SHADOW_EVSM", "DIRECTIONAL", "POINT", "SPOT"):
        assert getattr(lights, name) == getattr(j_lights, name), name


def _brdf_inputs(n=4096, seed=21):
    rng = np.random.default_rng(seed)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)  # noqa
    return {
        "l_type": rng.integers(0, 3, n).astype(np.int32),
        "l_pos": rng.normal(0, 4, (n, 3)).astype(np.float32),
        "l_dir": unit(rng.normal(size=(n, 3))),
        "l_intensity": rng.uniform(0, 5, (n, 3)).astype(np.float32),
        "l_atten": np.stack([np.ones(n), rng.uniform(0, 0.3, n), rng.uniform(0, 0.1, n)],
                            -1).astype(np.float32),
        "l_cutoff": np.sort(rng.uniform(0.5, 1.0, (n, 2)), -1)[:, ::-1].astype(np.float32).copy(),
        "l_radius": rng.uniform(1, 20, n).astype(np.float32),
        "albedo": rng.uniform(0, 1, (n, 4)).astype(np.float32),
        "metallic": rng.uniform(0, 1, n).astype(np.float32),
        "roughness": rng.uniform(0.05, 1, n).astype(np.float32),
        "f0": rng.uniform(0.02, 0.9, (n, 3)).astype(np.float32),
        "normal": unit(rng.normal(size=(n, 3))),
        "world_pos": rng.normal(0, 3, (n, 3)).astype(np.float32),
        "to_camera": unit(rng.normal(size=(n, 3))),
        "cos_lo": rng.uniform(0, 1, (n, 1)).astype(np.float32),
        "shadow": rng.uniform(0, 1, (n, 1)).astype(np.float32),
    }


def test_geometry_smith_matches_reference():
    """Within the lighting-model parity bar (tests/test_torch_path_tracer.py):
    |port - ref| / (1 + |ref|) <= 1e-6."""
    from sailor_tpu.kernels import pbr as j_pbr
    from sailor_tpu_torch.kernels import pbr

    x = _brdf_inputs()
    cos_li = x["cos_lo"][:, 0][::-1].copy()
    want = np.asarray(j_pbr.geometry_smith(jnp.asarray(cos_li), jnp.asarray(x["cos_lo"][:, 0]),
                                           jnp.asarray(x["roughness"])))
    got = pbr.geometry_smith(torch.from_numpy(cos_li), torch.from_numpy(x["cos_lo"][:, 0]),
                             torch.from_numpy(x["roughness"])).numpy()
    assert (np.abs(got - want) / (1 + np.abs(want))).max() <= 1e-6


def test_direct_lighting_matches_reference():
    """Within the shade test's bar (tests/test_torch_shade.py): relative
    error <= 1e-4 against max(|ref|, 1e-2)."""
    from sailor_tpu.kernels import pbr as j_pbr
    from sailor_tpu_torch.kernels import pbr

    x = _brdf_inputs()
    want = np.asarray(j_pbr.direct_lighting(**{k: jnp.asarray(v) for k, v in x.items()}))
    got = pbr.direct_lighting(**{k: torch.from_numpy(v) for k, v in x.items()}).numpy()
    assert got.shape == want.shape == (len(x["l_type"]), 3)
    assert np.isfinite(want).all() and want.max() > 0
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    assert err.max() <= 1e-4, err.max()


@pytest.mark.parametrize("reverse_z", [True, False])
@pytest.mark.parametrize("fov", [np.pi / 3, np.pi / 4, 1.1])
def test_perspective_matches_reference(reverse_z, fov):
    """Bit for bit, as the reverse-Z matrix already is in the frame tests."""
    from sailor_tpu.core import math3d as j_m3
    from sailor_tpu_torch.core import math3d as m3

    want = np.asarray(j_m3.perspective(fov, 16 / 9, 0.1, 150.0, reverse_z=reverse_z))
    got = m3.perspective(fov, 16 / 9, 0.1, 150.0, reverse_z=reverse_z).numpy()
    np.testing.assert_array_equal(got, want)
    depth = got @ np.array([0.0, 0.0, -0.1, 1.0], np.float32)
    assert np.isclose(depth[2] / depth[3], 1.0 if reverse_z else 0.0, atol=1e-6)


def test_camera_rays_flat_matches_reference():
    """Against the reference as its tracer runs it, compiled: origins equal,
    directions within 2e-6 * (1 + |ref|), a few float32 ulps of a unit
    vector (86% of them bit-equal): the reference's CPU rounding of the
    unprojection depends on its caller (ROADMAP C 2), and the port rounds
    as its own tracer does."""
    import jax

    from sailor_tpu.core import math3d as j_m3
    from sailor_tpu.raytracing import path_tracer as j_pt
    from sailor_tpu_torch.core import math3d as m3
    from sailor_tpu_torch.raytracing import path_tracer as pt

    rng = np.random.default_rng(3)
    eye, target = np.array([1.0, 2.0, 6.0]), np.array([0.0, 0.5, 0.0])
    view_j = j_m3.look_at(jnp.asarray(eye), jnp.asarray(target), jnp.asarray([0.0, 1.0, 0.0]))
    proj_j = j_m3.perspective(np.pi / 4, 1.5, 0.1, 100.0)
    px = rng.integers(0, 48, 500).astype(np.int32)
    py = rng.integers(0, 32, 500).astype(np.int32)
    ju, jv = rng.random((2, 500)).astype(np.float32)
    cam = np.asarray(eye, np.float32)
    o_ref, d_ref = jax.jit(j_pt.camera_rays_flat, static_argnums=(3, 4))(
        jnp.asarray(cam), view_j, proj_j, 48, 32, *(jnp.asarray(v) for v in (px, py, ju, jv)))
    o, d = pt.camera_rays_flat(torch.from_numpy(cam), torch.from_numpy(np.array(view_j)),
                               m3.perspective(np.pi / 4, 1.5, 0.1, 100.0), 48, 32,
                               *(torch.from_numpy(v) for v in (px, py, ju, jv)))
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    err = (np.abs(d.numpy() - np.asarray(d_ref)) / (1 + np.abs(np.asarray(d_ref)))).max()
    assert err <= 2e-6, err


def test_mesh_counts_match_reference():
    from sailor_tpu.assets import primitives as j_primitives
    from sailor_tpu_torch.assets import primitives

    for name, args in (("cube", (1.0,)), ("uv_sphere", (1.0, 8, 12)), ("plane", (2.0,))):
        got, want = getattr(primitives, name)(*args), getattr(j_primitives, name)(*args)
        assert (got.num_vertices, got.num_triangles) == (want.num_vertices, want.num_triangles)
        assert got.num_vertices == len(got.positions) and got.num_triangles == len(got.indices)


def test_native_bvh8_build_matches_reference_and_table():
    """``native_bridge.bvh8_build`` equals the table ``raytracing/bvh8.py``
    builds and traverses and the reference's native build, bit for bit."""
    from sailor_tpu import native_bridge as j_bridge
    from sailor_tpu_torch import native_bridge
    from sailor_tpu_torch.raytracing import bvh8
    from torch_bvh8_soups import soup

    for name in ("uv", "soup700"):
        v = soup(name)
        got = native_bridge.bvh8_build(*v)
        assert got.shape[1] == bvh8.ROW and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), bvh8.build_table(*v).view(np.int32))
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(j_bridge.bvh8_build(*v)).view(np.int32))


def test_native_load_raises_on_failed_build(monkeypatch, tmp_path):
    """A failed build of a host library raises, naming the compiler and the
    source; nothing falls back to Python and nothing is cached."""
    from sailor_tpu_torch import native_bridge
    from sailor_tpu_torch.kernels import host_lib

    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo broken 1.0 && exit 0\n"
                   "echo 'no compiler here' && exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(host_lib, "_libs", {})
    monkeypatch.setattr(host_lib, "_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="failed on host_runtime.cpp"):
        native_bridge.load()
    assert host_lib._libs == {}
