"""The port's bounds and octree (sailor_tpu_torch/core/bounds.py,
core/octree.py) against the JAX package's, on the CPU.

- Every bounds function on seeded random batches (4096 of each), against
  the reference compiled with ``jax.jit``: every float output equal bit
  for bit (planes, normalised planes, the six frustum planes, the bounding
  sphere, transformed AABBs, the slab test's entry, Moller-Trumbore's t, u
  and v) and every verdict equal (the frustum tests, the tile test, the
  slab and triangle hits). The reference run op by op rounds each product
  on its own, so against it the floats hold within 4 ulp of float32 (2e-6
  of the operands' scale) and the verdicts stay equal on these inputs.
- ``tests/test_math3d.py``'s bounds cases on the port.
- The octree: one script of inserts, AABB and frustum queries, removes and
  updates on both packages' octrees gives the same answers in the same
  order and the same tree (node centres, sizes and elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.core import bounds as jax_bounds
from sailor_tpu.core import math3d as jax_m3
from sailor_tpu.core.octree import Octree as JaxOctree
from sailor_tpu_torch.core import bounds, math3d as m3
from sailor_tpu_torch.core.octree import Octree
from test_torch_scenes import release_jax_executables  # noqa: F401 (autouse)

N = 4096


def _inputs():
    rng = np.random.default_rng(0)

    def f(*s):
        return rng.normal(size=s).astype(np.float32)

    p0, p1, p2 = f(N, 3), f(N, 3), f(N, 3)
    bmin = f(N, 3)
    return {
        "p0": p0, "p1": p1, "p2": p2, "vp": f(N, 4, 4), "c": f(N, 3),
        "r": np.abs(f(N)), "bmin": bmin, "bmax": bmin + np.abs(f(N, 3)),
        "pl4": f(N, 4, 4), "m": f(N, 4, 4), "o": f(N, 3), "d": f(N, 3),
    }


def _calls(mod, x, planes):
    """name -> outputs (a tuple) of each bounds function on the inputs."""
    return {
        "plane_from_points": (mod.plane_from_points(x["p0"], x["p1"], x["p2"]),),
        "normalize_plane": (mod.normalize_plane(x["vp"][:, 0]),),
        "extract_frustum_planes": (mod.extract_frustum_planes(x["vp"]),),
        "frustum_contains_sphere": (mod.frustum_contains_sphere(planes, x["c"], x["r"]),),
        "frustum_contains_aabb": (mod.frustum_contains_aabb(planes, x["bmin"], x["bmax"]),),
        "sphere_overlaps_tile_frustum": (
            mod.sphere_overlaps_tile_frustum(x["c"], x["r"], x["pl4"], 0.5, 2.0),),
        "aabb_union": mod.aabb_union(x["p0"], x["p1"], x["bmin"], x["bmax"]),
        "aabb_center_extents": mod.aabb_center_extents(x["bmin"], x["bmax"]),
        "aabb_to_sphere": (mod.aabb_to_sphere(x["bmin"], x["bmax"]),),
        "transform_aabb": mod.transform_aabb(x["m"], x["bmin"], x["bmax"]),
        "ray_aabb": mod.ray_aabb(x["o"], 1.0 / x["d"], x["bmin"], x["bmax"]),
        "ray_aabb_tmax": mod.ray_aabb(x["o"], 1.0 / x["d"], x["bmin"], x["bmax"], 2.0),
        "ray_triangle": mod.ray_triangle(x["o"], x["d"], x["p0"], x["p1"], x["p2"]),
    }


@pytest.fixture(scope="module")
def outputs():
    x = _inputs()
    planes = np.array(jax_bounds.extract_frustum_planes(x["vp"]))
    jitted = jax.jit(lambda x, planes: _calls(jax_bounds, x, planes))
    ref = jitted({k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(planes))
    eager = _calls(jax_bounds, {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(planes))
    got = _calls(bounds, {k: torch.from_numpy(v) for k, v in x.items()},
                 torch.from_numpy(planes))
    return got, ref, eager


@pytest.mark.parametrize("name", [
    "plane_from_points", "normalize_plane", "extract_frustum_planes", "frustum_contains_sphere",
    "frustum_contains_aabb", "sphere_overlaps_tile_frustum", "aabb_union",
    "aabb_center_extents", "aabb_to_sphere", "transform_aabb", "ray_aabb", "ray_aabb_tmax",
    "ray_triangle"])
def test_bounds_match_reference(outputs, name):
    got, ref, eager = (o[name] for o in outputs)
    assert len(got) == len(ref)
    for g, r, e in zip(got, ref, eager):
        g, r, e = g.numpy(), np.asarray(r), np.asarray(e)
        assert g.shape == r.shape and g.dtype == r.dtype
        if r.dtype == bool:
            np.testing.assert_array_equal(g, r)
            np.testing.assert_array_equal(g, e)
        else:
            np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32))
            ok = np.isfinite(e)
            scale = 1 + np.abs(e[ok])
            assert (np.abs(g[ok] - e[ok]) <= 2e-6 * scale).mean() >= (
                0.99 if name == "ray_triangle" else 1.0)


def test_verdicts_are_mixed(outputs):
    """The random batches reach both verdicts of every test."""
    got = outputs[0]
    for name in ("frustum_contains_sphere", "frustum_contains_aabb",
                 "sphere_overlaps_tile_frustum", "ray_aabb", "ray_triangle"):
        hit = got[name][-1] if name == "ray_triangle" else got[name][0]
        assert 0 < int(hit.sum()) < N, name


# --- tests/test_math3d.py's bounds cases on the port -------------------------


def test_frustum_sphere_culling():
    proj = m3.perspective(np.pi / 3, 1.0, 0.1, 100.0)
    view = m3.look_at(torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, -1.0]),
                      torch.tensor([0.0, 1.0, 0.0]))
    planes = bounds.extract_frustum_planes(proj @ view)
    centers = torch.tensor([[0.0, 0.0, -10.0], [0.0, 0.0, 10.0], [0.0, 0.0, -200.0],
                            [50.0, 0.0, -10.0], [0.0, 0.0, -0.05]])
    vis = bounds.frustum_contains_sphere(planes[None], centers, torch.ones(5))
    assert vis.tolist() == [True, False, False, False, True]


def test_frustum_aabb():
    planes = bounds.extract_frustum_planes(m3.perspective(np.pi / 3, 1.0, 0.1, 100.0))
    bmin = torch.tensor([[-1.0, -1.0, -11.0], [30.0, 30.0, -11.0]])
    bmax = torch.tensor([[1.0, 1.0, -9.0], [32.0, 32.0, -9.0]])
    assert bounds.frustum_contains_aabb(planes[None], bmin, bmax).tolist() == [True, False]


def test_ray_triangle():
    v0, v1, v2 = (torch.tensor(v) for v in ([0.0, 0.0, -5.0], [1.0, 0.0, -5.0],
                                             [0.0, 1.0, -5.0]))
    o = torch.tensor([[0.2, 0.2, 0.0], [0.9, 0.9, 0.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t, u, v, hit = bounds.ray_triangle(o, d, v0, v1, v2)
    assert hit.tolist() == [True, False]
    assert abs(float(t[0]) - 5.0) <= 1e-6


def test_ray_aabb():
    o, d = torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, -1.0])
    hit, t = bounds.ray_aabb(o, 1.0 / d, torch.tensor([-1, -1, -5.0]), torch.tensor([1, 1, -3.0]))
    assert bool(hit) and abs(float(t) - 3.0) <= 1e-6
    hit2, _ = bounds.ray_aabb(o, 1.0 / d, torch.tensor([-1, -1, 3.0]), torch.tensor([1, 1, 5.0]))
    assert not bool(hit2)


def test_transform_aabb():
    bmin, bmax = bounds.transform_aabb(m3.translation(torch.tensor([5.0, 0.0, 0.0])),
                                       torch.tensor([-1.0, -1.0, -1.0]),
                                       torch.tensor([1.0, 1.0, 1.0]))
    assert bmin.tolist() == [4.0, -1.0, -1.0] and bmax.tolist() == [6.0, 1.0, 1.0]


# --- the octree ------------------------------------------------------------------


def _tree(node):
    """A node and its subtree as nested tuples (centre bits, size, keys)."""
    return (node.center.tobytes(), node.size, tuple(node.elements),
            tuple(_tree(c) for c in node.children))


def _script(cls, planes):
    """tests/test_octree_normalmap.py's script, extended: 200 inserts, the
    queries, removes and updates; returns every answer and the tree."""
    ot = cls(size=100.0)
    rng = np.random.default_rng(0)
    out = []
    for k in range(200):
        c = rng.uniform(-40, 40, 3)
        e = rng.uniform(0.5, 2.0, 3)
        out.append(ot.insert(k, c - e, c + e))
    out.append(ot.insert(999, [-500.0] * 3, [500.0] * 3))  # outside the root: kept there
    out.append(ot.num_elements)
    out.append(ot.query_aabb([-10, -10, -10.0], [10, 10, 10.0]))
    out.append(ot.query_frustum(planes))
    out += [ot.remove(0), ot.remove(0), ot.update(1, [-1, -1, -1], [1, 1, 1])]
    out.append(ot.query_aabb([-2, -2, -2], [2, 2, 2]))
    for k in range(2, 60, 3):
        out.append(ot.update(k, *np.sort(rng.uniform(-45, 45, (2, 3)), 0)))
    out.append(ot.query_aabb([-30, -5, -30.0], [30, 5, 30.0]))
    out.append(ot.query_frustum(planes))
    out.append(ot.num_elements)
    return out, _tree(ot.root), {k: n.center.tobytes() for k, n in ot._where.items()}


def test_octree_matches_reference():
    view = jax_m3.look_at(jnp.asarray([0.0, 0.0, 60.0]), jnp.asarray([0.0, 0.0, 0.0]),
                          jnp.asarray([0.0, 1.0, 0.0]))
    proj = jax_m3.perspective(jnp.pi / 4, 1.0, 0.1, 200.0)
    planes = np.asarray(jax_bounds.extract_frustum_planes(proj @ view))
    got = _script(Octree, planes)
    want = _script(JaxOctree, planes)
    assert got == want
    answers = got[0]
    assert answers[:201] == [True] * 201 and answers[201] == 201
    assert 0 < len(answers[202]) < 200 and 0 < len(answers[203]) < 200
