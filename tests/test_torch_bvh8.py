"""The port's BVH8 and binary BVH against the JAX package's, on the CPU.

Same numpy soups and rays (``tests/torch_bvh8_soups.py``) through both
packages:
- tables: the host C++ build (``bvh8.build_table``, the port's copy of the
  native builder) equals ``sailor_tpu.raytracing.bvh8.build(use_native=True)``
  bit for bit, and the numpy collapse equals ``build(use_native=False)``, on
  the UV sphere of ``test_native.py``, the 700-triangle soup of
  ``test_sweep.py`` and ``tracer_soup(12, 24, 2)``;
- traversal: ``bvh8.intersect`` (its plain twin on the CPU) against the
  reference's lockstep ``intersect``, closest and any hit, with a finite
  t_max and with an active mask: hit and tri equal, t, u and v bit-equal
  (the twin rounds as the reference's compiled loop does: ROADMAP C 2),
  on rays through random points and on rays aimed at triangle edges, where
  u + v <= 1 and u, v >= 0 decide; also a root that is a leaf (5
  triangles), rays that all miss, all rays inactive, and the deep soup
  whose traversals drop pushes at MAX_STACK (the same subtrees as the
  reference's). The one exception: the reference compiles a one-row table
  (the leaf root) to another loop, which fuses t's dot as u's, not as the
  other tables' loop does; the port keeps one rounding, so there hit, tri,
  u and v are equal and t is within 1e-6 * (1 + |ref|) (measured: 3 of 11
  hits differ, by 2 ulp);
- the binary traversal ``bvh.intersect`` against the reference's
  ``bvh.intersect``: reordered triangle index, t, u, v bit-equal;
- ``sweep.scalar_bytes`` and ``SMEM_BUDGET``: the reference's routing rule;
- the twin's counts of a one-thread-a-ray warp schedule (``lane_steps``,
  ``warp_steps``, ``warp_branch_steps``) against a brute-force count over
  each ray's walk, on the UV sphere and the deep soup.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu import native_bridge
from sailor_tpu.raytracing import bvh as jax_bvh
from sailor_tpu.raytracing import bvh8 as jax_bvh8
from sailor_tpu.raytracing import sweep as jax_sweep
from sailor_tpu_torch.raytracing import bvh, bvh8, sweep
from test_torch_scenes import release_jax_executables  # noqa: F401
from torch_bvh8_soups import SOUPS, rays, soup

TABLE_SOUPS = ("uv", "soup700", "tracer")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_same(got, want, min_hits=1, t_rel=0.0):
    """hit, tri, u and v equal, t bit-equal (or within t_rel * (1 + |ref|))."""
    for k in ("hit", "tri", "u", "v"):
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]), k)
    t, t_ref = got["t"].numpy(), np.asarray(want["t"])
    if t_rel:
        hit = np.asarray(want["hit"])
        np.testing.assert_array_equal(t[~hit], t_ref[~hit])
        assert (np.abs(t[hit] - t_ref[hit]) <= t_rel * (1 + np.abs(t_ref[hit]))).all()
    else:
        np.testing.assert_array_equal(_bits(t), _bits(t_ref), "t")
    assert int(np.asarray(want["hit"]).sum()) >= min_hits


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", TABLE_SOUPS)
def test_table_matches_reference(name, use_native):
    if use_native:  # else the reference would build its Python table instead
        assert native_bridge.available()
    v = soup(name)
    want = np.asarray(jax_bvh8.build(*v, use_native=use_native).table)
    got = bvh8.build_table(*v, use_native=use_native)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert bvh8.build(*v, use_native=use_native, device="cpu").num_tris == len(v[0])


def _edge_rays(v, n=2000, seed=4):
    """Rays aimed at points on triangle edges (and just off them), from
    3 units away: the leaf's u, v >= 0 and u + v <= 1 tests decide."""
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, len(v[0]), n)
    corner = rng.integers(0, 3, n)
    a = np.stack(v)[corner, tri]
    b = np.stack(v)[(corner + 1) % 3, tri]
    p = a + rng.random((n, 1)).astype(np.float32) * (b - a)
    p += rng.normal(size=(n, 3)).astype(np.float32) * 1e-6 * (rng.random((n, 1)) < 0.5)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (p - 3.0 * d).astype(np.float32), d


CASES = {"closest": (False, None, False), "any": (True, None, False),
         "t_max": (False, 4.0, False), "active": (False, None, True),
         "any_t_max_active": (True, 4.0, True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", SOUPS)
def test_intersect_matches_reference(name, case):
    any_hit, t_max, use_active = CASES[case]
    v = soup(name)
    ref = jax_bvh8.build(*v)
    port = bvh8.from_numpy(np.asarray(ref.table), ref.num_tris, device="cpu")
    o, d, active = rays()
    if name in ("uv", "tracer"):
        eo, ed = _edge_rays(v)
        o, d = np.concatenate([o, eo]), np.concatenate([d, ed])
        active = np.concatenate([active, np.ones(len(eo), bool)])
    active = active if use_active else None
    want = jax_bvh8.intersect(ref, jnp.asarray(o), jnp.asarray(d),
                              None if t_max is None else jnp.float32(t_max), any_hit=any_hit,
                              active=None if active is None else jnp.asarray(active))
    work = {}
    args = bvh8.ray_inputs(torch.from_numpy(o), torch.from_numpy(d), t_max,
                           None if active is None else torch.from_numpy(active))
    t, tri, u, vv = bvh8.intersect_plain(port.table, *args, any_hit=any_hit, work=work)
    # a one-row table compiles to another loop in the reference, which fuses
    # t's dot as u's (ROADMAP C 2): t is then held within 1e-6
    t_rel = 1e-6 if name == "leaf_root" else 0.0
    _assert_same(dict(t=t, tri=tri, u=u, v=vv, hit=tri >= 0), want, t_rel=t_rel)
    got = bvh8.intersect(port, torch.from_numpy(o), torch.from_numpy(d), t_max,
                         any_hit=any_hit,
                         active=None if active is None else torch.from_numpy(active))
    _assert_same(got, want, t_rel=t_rel)
    if name == "deep" and case == "closest":
        assert work["dropped_pushes"] > 0
    distinct = work["distinct_leaf_rows"] + work["distinct_inner_rows"]
    assert distinct <= min(port.table.shape[0], work["leaf_rows"] + work["inner_rows"])
    if name == "leaf_root":
        assert work["inner_rows"] == 0 and work["iterations"] == 1
        assert work["distinct_leaf_rows"] == 1


def test_intersect_edge_cases_match_reference():
    """Every ray misses (they point away from the soup); every ray is
    inactive (t_max comes back, tri -1, u = v = 0)."""
    v = soup("soup700")
    ref = jax_bvh8.build(*v)
    port = bvh8.from_numpy(np.asarray(ref.table), ref.num_tris, device="cpu")
    o, d, _ = rays(500)
    o = o * 0 + np.float32([0.0, 0.0, 20.0])
    d = np.abs(d) * np.float32([1.0, 1.0, 1.0])
    d[:, 2] += 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = jax_bvh8.intersect(ref, jnp.asarray(o), jnp.asarray(d))
    got = bvh8.intersect(port, torch.from_numpy(o), torch.from_numpy(d))
    _assert_same(got, want, min_hits=0)
    assert not got["hit"].any()
    off = np.zeros(len(o), bool)
    want = jax_bvh8.intersect(ref, jnp.asarray(o), jnp.asarray(d), jnp.float32(7.0),
                              active=jnp.asarray(off))
    got = bvh8.intersect(port, torch.from_numpy(o), torch.from_numpy(d), 7.0,
                         active=torch.from_numpy(off))
    _assert_same(got, want, min_hits=0)
    assert bool((got["t"] == 7.0).all()) and not got["u"].any() and not got["v"].any()


@pytest.mark.parametrize("case", ["closest", "any_t_max_active"])
@pytest.mark.parametrize("name", ["uv", "deep"])
def test_warp_counts_match_brute_force(name, case):
    """``work``'s lane_steps, warp_steps and warp_branch_steps against a
    count over each ray's walk (its rows' kinds in order, from ``on_step``),
    warps being 32 consecutive rays: lane steps are all rows; a warp runs
    as many steps as its longest walk; step j runs the leaf branch if one
    of its rays' row j is a leaf, the internal branch if one is not."""
    any_hit, t_max, use_active = CASES[case]
    table = torch.from_numpy(bvh8.build_table(*soup(name)))
    o, d, active = rays()
    args = bvh8.ray_inputs(torch.from_numpy(o), torch.from_numpy(d), t_max,
                           torch.from_numpy(active) if use_active else None)
    record, work = [], {}
    bvh8.intersect_plain(table, *args, any_hit=any_hit, work=work,
                         on_step=lambda idx, leaf: record.append((idx.numpy().copy(),
                                                                  leaf.numpy().copy())))
    walks = [[] for _ in range(len(o))]
    for idx, leaf in record:
        for i, f in zip(idx, leaf):
            walks[i].append(bool(f))
    lane = warp = branch = 0
    for w0 in range(0, len(walks), 32):
        group = walks[w0:w0 + 32]
        longest = max(len(w) for w in group)
        lane += sum(len(w) for w in group)
        warp += longest
        branch += sum(len({w[j] for w in group if len(w) > j}) for j in range(longest))
    assert work["lane_steps"] == lane == work["leaf_rows"] + work["inner_rows"]
    assert work["warp_steps"] == warp
    assert work["warp_branch_steps"] == branch
    assert warp <= branch <= 2 * warp and 32 * warp >= lane


@pytest.mark.parametrize("name", TABLE_SOUPS)
def test_binary_intersect_matches_reference(name):
    v = soup(name)
    ref, port = jax_bvh.build(*v), bvh.build(*v)
    o, d, _ = rays(2000, seed=5)
    for t_max, any_hit in ((np.inf, False), (np.inf, True), (3.0, False)):
        want = jax_bvh.intersect(ref, jnp.asarray(o), jnp.asarray(d), t_max, any_hit=any_hit)
        got = bvh.intersect(port, torch.from_numpy(o), torch.from_numpy(d), t_max,
                            any_hit=any_hit)
        _assert_same(got, want)


class _Clusters:
    def __init__(self, n):
        self.n_clusters = n


def test_scalar_bytes_and_budget_match_reference():
    """The reference's routing rule: on the bench tracer scene (73 clusters)
    at 512x512 one and two pooled samples stay within 1 MiB, four do not."""
    assert sweep.SMEM_BUDGET == jax_sweep.SMEM_BUDGET == 1 << 20
    for nc in (1, 73, 1000):
        for r in (1, 2047, 2048, 2049, 262144, 2 * 262144, 4 * 262144):
            assert sweep.scalar_bytes(_Clusters(nc), r) == jax_sweep.scalar_bytes(
                _Clusters(nc), r)
    assert [sweep.scalar_bytes(_Clusters(73), sb * 262144) for sb in (1, 2, 4)] == [
        336384, 672768, 1345536]
