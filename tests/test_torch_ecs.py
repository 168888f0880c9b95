"""The port's ECS (sailor_tpu_torch/ecs) against the JAX package's on
inputs made from a numpy seed, on the CPU.

Tolerances: none but where stated. The component pool gives the same
handles through acquire, release and growth. World matrices are bit-equal
to the reference's compiled ``compute_world_matrices`` on random
three-level hierarchies at the pool's sizes (the port rounds ``trs`` and
each level's product as XLA:CPU's compiled function does: fused
multiply-adds, ``math3d.fma``). The soup transform (positions and
normals) is bit-equal to the compiled ``_transform_soup``, and the light
table and the camera's FrameData of a ticked world are bit-equal to the
reference's. The quaternion helpers run plain float32 where the
reference's op-by-op run takes its own sin and cos: within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import math3d as j_m3
from sailor_tpu.ecs.ecs import ComponentPool as JPool
from sailor_tpu.ecs.static_mesh import _transform_soup as j_transform_soup
from sailor_tpu.ecs.transform import compute_world_matrices as j_world_matrices
from sailor_tpu.engine import World as JWorld
from sailor_tpu.engine import components as j_comp
from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.ecs.ecs import ComponentPool
from sailor_tpu_torch.ecs.static_mesh import normal_matrices, transform_soup
from sailor_tpu_torch.ecs.transform import compute_world_matrices
from sailor_tpu_torch.engine import World
from sailor_tpu_torch.engine import components as comp
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

LIGHT_FIELDS = ("type", "shadow_type", "position", "direction", "intensity", "attenuation",
                "cutoff", "radius")
FRAME_FIELDS = ("view", "projection", "inv_projection", "camera_position",
                "camera_z_near_far", "current_time", "delta_time")


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _hierarchy(rng, n, levels=3):
    """Random transforms: a quarter roots, then each further quarter
    parented into the one before (so ``levels`` + 1 deep)."""
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (n, 3)).astype(np.float32)
    parent = np.full(n, -1, np.int32)
    step = n // (levels + 1)
    for lv in range(1, levels + 1):
        parent[lv * step:(lv + 1) * step] = rng.integers((lv - 1) * step, lv * step, step)
    return pos, _unit_quats(rng, n), scale, parent


def test_component_pool_handles_match_jax():
    """Acquire, release and growth past the capacity give the same handles,
    liveness, capacity and field arrays (grown slots zero, as in the
    reference)."""
    rng = np.random.default_rng(3)
    fields = {"v": ((3,), np.float32, (1.0, 2.0, 3.0)), "i": ((), np.int32, -1)}
    got, ref = ComponentPool(fields, 4), JPool(fields, 4)
    live = []
    for step in range(200):
        if live and rng.random() < 0.35:
            h = live.pop(int(rng.integers(len(live))))
            got.release(h)
            ref.release(h)
        else:
            h = got.acquire()
            assert h == ref.acquire()
            got.v[h] = ref.v[h] = rng.uniform(-1, 1, 3)
            live.append(h)
    assert got.capacity == ref.capacity >= 64 and got.num_alive == ref.num_alive
    np.testing.assert_array_equal(got.alive, ref.alive)
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("n,levels", [(1024, 1), (1024, 4), (2048, 4)])
def test_world_matrices_bit_equal(n, levels):
    """compute_world_matrices at the pool's sizes: roots only (levels 1,
    the hierarchy ignored) and random three-level hierarchies resolved
    with one spare level."""
    pos, rot, scale, parent = _hierarchy(np.random.default_rng(n + levels), n)
    ref = np.asarray(j_world_matrices(pos, rot, scale, parent, levels=levels))
    got = compute_world_matrices(pos, rot, scale, parent, levels)
    assert got.dtype == np.float32 and (parent >= 0).any()
    np.testing.assert_array_equal(got, ref)


def test_transform_soup_bit_equal():
    """Positions and normals of a random soup over 97 instances equal the
    reference's compiled transform bit for bit; the normal matrices
    equal its batched inverse, transposed."""
    rng = np.random.default_rng(5)
    n_inst, n_vert = 97, 20000
    pos, rot, scale, _ = _hierarchy(rng, n_inst, levels=0)
    mats = compute_world_matrices(pos, rot, scale, np.full(n_inst, -1, np.int32), 1)
    lp = rng.uniform(-2, 2, (n_vert, 3)).astype(np.float32)
    ln = rng.normal(size=(n_vert, 3))
    ln = (ln / np.linalg.norm(ln, axis=1, keepdims=True)).astype(np.float32)
    inst = np.sort(rng.integers(0, n_inst, n_vert)).astype(np.int32)
    ref_p, ref_n = (np.asarray(a) for a in j_transform_soup(lp, ln, inst, mats))
    nm = normal_matrices(mats[:, :3, :3])
    np.testing.assert_array_equal(
        nm, np.transpose(np.asarray(jnp.linalg.inv(mats[:, :3, :3])), (0, 2, 1)))
    p, nrm = transform_soup(torch.from_numpy(lp), torch.from_numpy(ln),
                            torch.from_numpy(inst).long(),
                            torch.from_numpy(np.ascontiguousarray(mats[:, :3, :])),
                            torch.from_numpy(nm))
    np.testing.assert_array_equal(p.numpy(), ref_p)
    np.testing.assert_array_equal(nrm.numpy(), ref_n)


def _lit_world(world_cls, c, device=None):
    """A camera under a rotated parent, spot and point lights under moving
    parents, a sun, and two meshes."""
    w = world_cls() if device is None else world_cls(device=device)
    rng = np.random.default_rng(9)
    rig = w.instantiate("rig")
    rig.position = [1.0, 2.0, 3.0]
    rig.rotation = _unit_quats(rng, 1)[0]
    cam = w.instantiate("cam")
    cam.set_parent(rig)
    cam.position = [0.0, 3.0, 12.0]
    cam.add_component(c.CameraComponent(fov_degrees=55.0, aspect=4 / 3, z_far=80.0))
    for i in range(6):
        lamp = w.instantiate(f"lamp{i}")
        lamp.set_parent(rig if i % 2 else None)
        lamp.position = rng.uniform(-5, 5, 3).tolist()
        lamp.rotation = _unit_quats(rng, 1)[0]
        lamp.add_component(c.LightComponent(
            light_type=2 if i % 3 == 0 else 1, intensity=rng.uniform(0.5, 3, 3).tolist(),
            direction=rng.normal(size=3).tolist(), radius=float(rng.uniform(2, 6))))
    sun = w.instantiate("sun")
    sun.add_component(c.LightComponent(light_type=0, direction=(-0.35, -0.7, -0.3)))
    for name, asset in (("box", "cube"), ("ball", "sphere")):
        go = w.instantiate(name)
        go.set_parent(rig)
        go.position = rng.uniform(-3, 3, 3).tolist()
        go.scale = rng.uniform(0.5, 2, 3).tolist()
        go.add_component(c.MeshRendererComponent(mesh_asset=asset))
    return w, rig


def test_lights_and_camera_frame_bit_equal():
    """A ticked world's light table and camera FrameData equal the
    reference's bit for bit, on the first tick and after the rig moved;
    the table is rebuilt only when a transform or a light changed."""
    got, g_rig = _lit_world(World, comp, device="cpu")
    ref, r_rig = _lit_world(JWorld, j_comp)
    for step in range(3):
        if step == 2:
            for rig in (g_rig, r_rig):
                rig.position = [0.5, 2.5, -1.0]
        got.tick(1 / 60)
        ref.tick(1 / 60)
        gl, rl = got.lighting.snapshot, ref.lighting.snapshot
        assert gl.num == int(rl.num) == 7 and gl.capacity == rl.capacity == 8
        for f in LIGHT_FIELDS:
            np.testing.assert_array_equal(getattr(gl, f).numpy(), np.asarray(getattr(rl, f)), f)
        gf, rf = got.cameras.main_frame(), ref.cameras.main_frame()
        for f in FRAME_FIELDS:
            np.testing.assert_array_equal(getattr(gf, f).numpy(), np.asarray(getattr(rf, f)), f)
        for f in ("position", "normal", "indices"):
            np.testing.assert_array_equal(getattr(got.meshes.geometry, f).numpy(),
                                          np.asarray(getattr(ref.meshes.geometry, f)), f)
        if step == 0:
            first = gl
    assert got.lighting.snapshot is not first  # the rig moved: rebuilt
    version = got.transforms.version
    got.tick(1 / 60)
    assert got.transforms.version == version
    snap = got.lighting.snapshot
    got.tick(1 / 60)
    assert got.lighting.snapshot is snap  # nothing changed: cached


@pytest.mark.parametrize("fov,aspect", [(np.pi / 3, 16 / 9), (np.deg2rad(60.0), 128 / 96),
                                        (0.7, 1.0), (1.2, 2.5)])
def test_perspective_bit_equal(fov, aspect):
    """perspective takes tan from the C library's tanf, as the
    reference's jnp.tan rounds on a CPU."""
    fov = float(np.float32(fov))
    np.testing.assert_array_equal(m3.perspective(fov, aspect, 0.1, 150.0).numpy(),
                                  np.asarray(j_m3.perspective(fov, aspect, 0.1, 150.0)))


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(2)
    q, r = _unit_quats(rng, 64), _unit_quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    pairs = [
        (m3.quat_mul(q, r), j_m3.quat_mul(q, r)),
        (m3.quat_conj(q), j_m3.quat_conj(q)),
        (m3.quat_rotate(q, v), j_m3.quat_rotate(q, v)),
        (m3.quat_from_axis_angle(v, ang), j_m3.quat_from_axis_angle(v, ang)),
        (m3.quat_to_mat3(q), j_m3.quat_to_mat3(q)),
        (m3.quat_from_euler(ang[0], ang[1], ang[2]),
         j_m3.quat_from_euler(ang[0], ang[1], ang[2])),
        (m3.translation(v), j_m3.translation(v)),
        (m3.scale(v), j_m3.scale(v)),
        (m3.trs(v, q, v), j_m3.trs(v, q, v)),
        (m3.identity4((2,)), j_m3.identity4((2,))),
        (m3.quat_identity((3,)), j_m3.quat_identity((3,))),
        (m3.mat3_to_quat(m3.quat_to_mat3(q)), j_m3.mat3_to_quat(j_m3.quat_to_mat3(q))),
        (m3.quat_look_rotation(v[0]), j_m3.quat_look_rotation(v[0])),
    ]
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))
    # the look rotation makes the inverse of its model matrix a look-at view
    eye, target = np.array([35.36, 10.0, 0.0], np.float32), np.array([0.0, 0.5, 0.0], np.float32)
    model = m3.trs(eye, m3.quat_look_rotation(target - eye), np.ones(3, np.float32))
    view = m3.look_at(torch.from_numpy(eye), torch.from_numpy(target), torch.tensor([0.0, 1, 0]))
    np.testing.assert_allclose(m3.inverse(model).numpy(), view.numpy(), atol=2e-5)


def test_world_device_is_used():
    """A world's snapshot lives on its device."""
    w, _ = _lit_world(World, comp, device="cpu")
    w.tick(1 / 60)
    sv = w.scene_view()
    assert sv.geometry.position.device.type == "cpu" and sv.lights.type.device.type == "cpu"
    assert sv.frame.view.device.type == "cpu" and sv.attrs_packed.shape[1] == 37
