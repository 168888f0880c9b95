"""The sweep's ray block and sub-block sizes (``SAILOR_SWEEP_RAY_BLOCK``,
``SAILOR_SWEEP_SUB``) in the port against the JAX package's, on the CPU.

Both packages read the pair at import into ``sweep.RAY_BLOCK`` and
``sweep.SUB``; here the ``pair`` fixture sets both modules' (and clears
JAX's caches on entry and exit: the reference's jitted ``intersect`` reads
them while it traces). At (512, 64), (1536, 192), (2048, 2048) and
(96, 1), on the same numpy inputs:

- B4: ``slab_entry_plain`` against the reference's fused kernel
  ``_slab_entry_sub`` (Pallas interpret mode), at ``test_torch_sweep.py``'s
  bars: finiteness equal, finite entries within 1e-6 relative; at (96, 1),
  where the reference's compiled slab contracts a product into the
  following subtraction (7 of 345 entries differ by up to 5.4e-6
  relative), within one float32 ulp of the subtraction's operands (|ref|
  plus the ray's largest |o * inv|) for the rays that are not
  axis-parallel, as ``test_visit_tables_match_reference[soup_c32]`` holds
  them; the bar must catch entries scaled by 1 + 1e-5; and the visit
  tables built from the reference's entries equal to the reference's;
- ``intersect`` at every pair with closest hit and ``t_max``, the port
  with B5 and with B6 (``DMA_SWEEP`` on and off) against the reference's
  DMA walk; at (512, 64) and (1536, 192) also with any hit and ``active``;
  at (512, 64) closest hit with ``active`` against the reference's grid
  kernel with ``DMA_SWEEP`` off on both sides; at ``test_torch_sweep.py``'s
  bars (``_check_intersect``);
- the card kernels' plain models (``chip_smoke.packed_walk``,
  ``sub_entries``, ``visit_order``) equal to the twins at the pair;
- ``scalar_bytes`` equal to the reference's on several ray counts, and
  ``path_tracer._swizzle_maps`` equal to the reference's at each pair and
  at sub-blocks of 100 and 192 rays;
- pairs the sweep cannot take: the port raises ValueError naming both
  variables at (2048, 768), (256, 512), SUB = 0 and RAY_BLOCK = 0, from
  ``scalar_bytes``, ``prepare`` and ``intersect``, before anything runs; the reference
  raises at the first two too.

``SAILOR_SWEEP_RAY_BLOCK=1024 SAILOR_SWEEP_SUB=128`` in a subprocess
(``torch_sweep_rayblock_env.py``): both packages read the pair at import,
and a 32x32 render of the port equals the reference's.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.raytracing import path_tracer as jax_pt
from sailor_tpu.raytracing import sweep as jax_sweep
from chip_smoke import packed_walk, sub_entries, tied_clusters, visit_order
from sailor_tpu_torch.raytracing import path_tracer as pt
from sailor_tpu_torch.raytracing import sweep
from test_torch_scenes import release_jax_executables  # noqa: F401
from test_torch_sweep import _check_intersect, _reference_tables, _soup, _tracer_tris

PAIRS = [(512, 64), (1536, 192), (2048, 2048), (96, 1)]
REFUSED = [(2048, 768), (256, 512), (2048, 0), (0, 256)]


def _ids(pairs):
    return [f"{rb}-{sub}" for rb, sub in pairs]


def _set_pair(monkeypatch, rb, sub, reference=True):
    for mod in (sweep, jax_sweep) if reference else (sweep,):
        monkeypatch.setattr(mod, "RAY_BLOCK", rb)
        monkeypatch.setattr(mod, "SUB", sub)


@pytest.fixture(params=PAIRS, ids=_ids(PAIRS))
def pair(request, monkeypatch):
    """Both packages at the (RAY_BLOCK, SUB) pair of the parameter."""
    jax.clear_caches()
    _set_pair(monkeypatch, *request.param)
    yield request.param
    monkeypatch.undo()
    jax.clear_caches()


def _feats(rng, rays):
    """Random rays as the kernels' feature rows, from a shell of radius 11-16
    around the soup (which lies in [-6, 6]^3) toward points in it, so no
    origin lies in a cluster's box and every entry is positive; every 7th
    axis-parallel (the 1e12 branch) and every 5th dead: (feats, tmax)
    numpy."""
    u = rng.normal(size=(rays, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = (u * rng.uniform(11, 16, (rays, 1))).astype(np.float32)
    d = (rng.uniform(-5, 5, (rays, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1] = 0.0
    tmax = np.full(rays, np.inf, np.float32)
    tmax[::5] = -1.0
    m = np.cross(o, d)
    z = np.zeros((rays, 1), np.float32)
    return np.concatenate([d, m, z, z, o, z + 1, d, z], 1).astype(np.float32), tmax


def _entry_bars(feats, tmax, lo, hi, want, sub):
    """Each ray's entry into each box, as the twin computes it (float32,
    every product and difference rounded alone), and the bar of each
    sub-block entry against the reference's ``want``, whose compiled slab
    contracts a product into the following subtraction: one float32 ulp of
    that subtraction's operands, 2**-23 * (|entry| + the ray's largest
    |o * inv| over its axes that are not parallel: an axis-parallel ray's
    1e12 terms never decide a finite entry), taken over every ray that can
    attain the reference's minimum (f - bar <= want) and the ray that
    attains the twin's. Returns (the sub-block minima, the bars)."""
    d, o = feats[:, 0:3], feats[:, 8:11]
    parallel = np.abs(d) <= 1e-12
    inv = np.where(parallel, np.float32(1e12), np.float32(1) / np.where(parallel, 1, d))
    oinv = o * inv
    a = inv[:, None, :] * lo[None] - oinv[:, None, :]
    b = inv[:, None, :] * hi[None] - oinv[:, None, :]
    tn, tf = np.minimum(a, b).max(2), np.maximum(a, b).min(2)
    hit = (tn <= np.minimum(tmax[:, None], tf)) & (tf > 0)
    f = np.where(hit, np.maximum(tn, np.float32(0)), np.float32(np.inf))  # (rays, clusters)
    scale = np.where(parallel, 0, np.abs(oinv)).max(1)
    delta = 2.0 ** -23 * (np.where(hit, f, 0) + scale[:, None])
    f_s, delta_s = f.reshape(-1, sub, f.shape[1]), delta.reshape(-1, sub, f.shape[1])
    mins = f_s.min(1)
    can = (f_s - delta_s <= want[:, None, :]) | (f_s == mins[:, None, :])
    return mins, np.where(can & np.isfinite(f_s), delta_s, 0).max(1)


def test_slab_entry_and_tables_match_reference(pair):
    rb, sub = pair
    v0, v1, v2 = _soup(7, t=1500)
    ref_scene = jax_sweep.build(v0, v1, v2)
    rpad = 2 * rb
    feats, tmax = _feats(np.random.default_rng(9), rpad)
    e_ref = jax_sweep._slab_entry_sub(ref_scene, jnp.asarray(feats), jnp.asarray(tmax), rpad)
    want = np.asarray(e_ref)
    assert want.shape == (rpad // sub, ref_scene.n_clusters)
    lo, hi = np.asarray(ref_scene.cl_min), np.asarray(ref_scene.cl_max)
    got = sweep.slab_entry_plain(torch.from_numpy(feats), torch.from_numpy(tmax),
                                 torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    fin = np.isfinite(want)
    assert 0.3 < fin.mean() and (want[fin] > 0).all()
    np.testing.assert_array_equal(np.isfinite(got), fin)
    mins, bars = _entry_bars(feats, tmax, lo, hi, want, sub)
    np.testing.assert_array_equal(got, mins)  # the twin is the per-ray minimum
    want_f = np.where(fin, want, 0)
    bar = np.maximum(1e-6 * np.abs(want_f), bars)

    def misses(entries):
        return int((np.abs(np.where(fin, entries, 0) - want_f) > bar).sum())

    assert misses(got) == 0
    # the bar sees a relative error of 1e-5 on most entries
    assert misses(got * np.float32(1 + 1e-5)) > 0.5 * fin.sum()
    tables = sweep.tables_from_entries(torch.from_numpy(want))
    for k, v in _reference_tables(e_ref, 2).items():
        np.testing.assert_array_equal(tables[k].numpy(), v, k)
    # chip_smoke's models of B4: its entries back from the tables, its rank
    e_sub = sub_entries(tables)
    np.testing.assert_array_equal(e_sub.numpy(), want.view(np.int32))
    e_blk = e_sub.view(2, rb // sub, -1).amin(1)
    assert torch.equal(visit_order(e_blk).to(torch.int32), tables["order"])


# (pair, case, kernel): "dma", the port with B5 and with B6 against the
# reference's DMA walk; "grid", B6 against the reference's grid kernel
# (``DMA_SWEEP`` off on both sides). Every pair holds closest hit with
# t_max; any hit and the grid kernel at two pairs, since the reference
# compiles anew for each case (about 20 s at (96, 1)).
INTERSECT = [(p, "closest_tmax", "dma") for p in PAIRS] + [
    ((512, 64), "any_active", "dma"), ((1536, 192), "any_active", "dma"),
    ((512, 64), "closest_active", "grid")]


@pytest.mark.parametrize("pair,case,kernel", INTERSECT, indirect=["pair"],
                         ids=[f"{rb}-{sub}-{c}-{k}" for (rb, sub), c, k in INTERSECT])
def test_intersect_matches_reference(pair, monkeypatch, case, kernel):
    if kernel == "grid":
        monkeypatch.setattr(jax_sweep, "DMA_SWEEP", False)
        monkeypatch.setattr(sweep, "DMA_SWEEP", False)
        _check_intersect("soup", case)
    else:
        _check_intersect("soup", case, port_dma=(True, False))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_kernel_mapping_matches_twins(pair, any_hit):
    """``packed_walk`` (the kernels' mapping) equals ``sweep_plain`` and
    ``sweep_grid_plain`` bit for bit at the pair, on the tracer scene's rays
    (a third of them inactive) and on tied clusters."""
    rb, sub = pair
    scene = sweep.build(*_tracer_tris(), device="cpu")
    rng = np.random.default_rng(13)
    r = 2 * rb
    o = rng.uniform([-6, 1e-3, -4], [6, 2, 4], (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = torch.from_numpy(rng.random(r) > 0.3)
    p = sweep.prepare(scene, torch.from_numpy(o), torch.from_numpy(d), active=active)
    assert p["e_bits"].shape == (r // sub, scene.n_clusters)
    for g in (scene.g_cluster, tied_clusters(scene.g_cluster)):
        t, i = sweep.sweep_plain(p["e_bits"], p["order"], p["blk_bits"], p["nlive"],
                                 p["feats"], p["tmax"], g, any_hit=any_hit)
        t_g, i_g = sweep.sweep_grid_plain(p["e_bits"], p["order"], p["feats"], p["tmax"], g,
                                          any_hit=any_hit)
        t_m, i_m, _ = packed_walk(p, g, any_hit=any_hit)
        for tt, ii in ((t_g, i_g), (t_m, i_m)):
            assert torch.equal(ii, i)
            assert torch.equal(tt.view(torch.int32), t.view(torch.int32))
        assert int((i >= 0).sum()) > 0.1 * r


def test_scalar_bytes_and_swizzle_match_reference(pair):
    rb, sub = pair

    class _Clusters:
        n_clusters = 73

    for r in (1, rb - 1, rb, rb + 1, 3000, 262144, 1048576):
        assert sweep.scalar_bytes(_Clusters, r) == jax_sweep.scalar_bytes(_Clusters, r), r
    for h, w in ((32, 32), (100, 192), (61, 37)):
        got = pt._swizzle_maps(h, w, sweep.RAY_BLOCK, sweep.SUB)
        want = jax_pt._swizzle_maps(h, w, jax_sweep.RAY_BLOCK, jax_sweep.SUB)
        assert got[2] == want[2] == pt.rays_per_sample(w, h)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rb,sub", [(800, 100), (1536, 192)], ids=["800-100", "1536-192"])
def test_swizzle_matches_reference_at_sizes_no_power_of_two(monkeypatch, rb, sub):
    """The tile swizzle at sub-blocks of 100 and 192 rays (subtiles of 8 x 12
    and 8 x 24 pixels, which do not tile the sub-block exactly) and the
    render's padded ray count, against the reference's."""
    _set_pair(monkeypatch, rb, sub)
    for h, w in ((64, 64), (100, 192), (61, 37)):
        got = pt._swizzle_maps(h, w, sweep.RAY_BLOCK, sweep.SUB)
        want = jax_pt._swizzle_maps(h, w, jax_sweep.RAY_BLOCK, jax_sweep.SUB)
        assert got[2] == want[2] == pt.rays_per_sample(w, h)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)


def test_batch4_routes_to_the_sweep_at_8192_1024(monkeypatch):
    """The routing rule at tracer-512-batch4's 1,048,576-ray passes (73
    clusters): the BVH8 at the default pair, the sweep at (8192, 1024)
    (336 KB), and tracer-512's 262,144-ray passes leave the sweep at
    (2048, 64) and (512, 16)."""

    class _Clusters:
        n_clusters = 73

    def routed(rb, sub, rays):
        _set_pair(monkeypatch, rb, sub)
        bytes_ = sweep.scalar_bytes(_Clusters, rays)
        assert bytes_ == jax_sweep.scalar_bytes(_Clusters, rays)
        return bytes_ <= sweep.SMEM_BUDGET

    assert not routed(2048, 256, 1048576)
    assert routed(8192, 1024, 1048576)
    assert sweep.scalar_bytes(_Clusters, 1048576) == 336384
    assert routed(2048, 256, 262144)
    assert not routed(2048, 64, 262144) and not routed(512, 16, 262144)


@pytest.mark.parametrize("rb,sub", REFUSED, ids=_ids(REFUSED))
def test_refused_pairs_raise(monkeypatch, rb, sub):
    jax.clear_caches()
    _set_pair(monkeypatch, rb, sub)
    scene = sweep.build(*_soup(7, t=300), device="cpu")
    o = torch.zeros(100, 3)
    d = torch.nn.functional.normalize(torch.ones(100, 3), dim=1)
    for call in (lambda: sweep.scalar_bytes(scene, 100), lambda: sweep.prepare(scene, o, d),
                 lambda: sweep.intersect(scene, o, d), lambda: sweep.slab_smem_clusters()):
        with pytest.raises(ValueError, match="SAILOR_SWEEP_RAY_BLOCK.*SAILOR_SWEEP_SUB"):
            call()
    if (rb, sub) in REFUSED[:2]:  # the reference fails in a reshape (TypeError)
        ref = jax_sweep.build(*_soup(7, t=300))
        with pytest.raises(TypeError):
            jax_sweep.intersect(ref, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    monkeypatch.undo()
    jax.clear_caches()


def test_sweep_rayblock_environment_sets_the_pair():
    """``SAILOR_SWEEP_RAY_BLOCK=1024 SAILOR_SWEEP_SUB=128``, read at import
    by both packages, in a fresh process (``tests/torch_sweep_rayblock_env.py``
    says what it checks)."""
    env = {**os.environ, "SAILOR_SWEEP_RAY_BLOCK": "1024", "SAILOR_SWEEP_SUB": "128",
           "JAX_PLATFORMS": "cpu"}
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, os.path.join(here, "torch_sweep_rayblock_env.py")],
                         cwd=os.path.dirname(here), env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ray_block=1024 sub=128 " in out.stdout and "render close=" in out.stdout, out.stdout
