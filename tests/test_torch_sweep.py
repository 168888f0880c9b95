"""The port's sweep intersector against the JAX package's, on the CPU.

Same numpy inputs through both packages:
- ``bvh.build`` and ``sweep.build``: every array exactly equal (the leaf
  order fixes the clusters and the tie-break between equal t), also at
  cluster sizes 37, 64, 128, 512 and 1024 (``build(cluster=)``), where the
  port's ``SweepScene.cluster`` is the size;
- B4: the port's ``slab_entry_plain`` against the reference's fused kernel
  ``_slab_entry_sub`` (Pallas interpret mode): finiteness equal, finite
  entries within 1e-6 relative (XLA may contract a product into the
  following subtraction; the port rounds the two separately);
- B5 through ``intersect``: closest hit, any hit, ``active`` and ``t_max``
  on a random soup and on the small tracer scene, and again against the
  reference's grid kernel (``DMA_SWEEP`` off, B6): ``hit`` equal on
  >= 99.9% of rays, ``tri`` equal on >= 99.9% of the rays both hit, and
  where both hit the same triangle, t within 1e-5 * max(1, |ref|) and the
  hit point that u and v give (|du| times the triangle's longest edge)
  within 1e-5 * max(1, t) (the refinement's crosses and dots may be fused
  by XLA);
- B6, the port's grid sweep (``DMA_SWEEP`` off), against the reference's
  grid kernel in all four cases at the same bounds, and its twin equal to
  B5's twin bit for bit (t bits and ids) on the same tables;
- B5 and B6 at cluster sizes 37, 128 and 512, closest and any hit, at the
  same bounds, on the random soup and on a soup of duplicated triangles
  (every hit an exact tie: within a cluster the larger column wins, across
  clusters the earlier-visited one);
- ``SAILOR_SWEEP_CLUSTER=128`` in a subprocess (``torch_sweep_cluster_env.py``):
  both packages' ``CLUSTER`` and ``build``'s default are 128, and a 32x32
  render of the port's own scene with the reference's uniforms equals the
  reference's render under the same environment at the render test's bar;
- ``intersect(sort_rays=True)`` against the reference's, on both scenes,
  at the same bounds;
- the card kernels' mapping (``chip_smoke.packed_walk``: live rays packed
  per step, 8 slices of 32 triangles each reduced to its least t with
  equal t to the larger column, merged in slice order; any hit as a flag)
  equal to ``sweep_plain`` bit for bit, at 0, 5, 50 and 100% of the rays
  active, with a sub-block of exactly 1 and one of 33 live rays, and on
  clusters with exact ties;
- B4's tables past 1,024 clusters: a 40,000-triangle soup at cluster 32
  (1,250 clusters) on two ray blocks, against the reference's entries and
  tables.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailor_tpu.raytracing import bvh as jax_bvh
from sailor_tpu.raytracing import sweep as jax_sweep
from chip_smoke import packed_walk, sub_entries, tied_clusters, visit_order
from sailor_tpu_torch.raytracing import bvh, sweep
from sailor_tpu_torch.scenes import tracer_soup
from test_torch_scenes import release_jax_executables  # noqa: F401


def _soup(seed=1, t=1500):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-5, 5, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _tracer_tris():
    soup = tracer_soup(12, 24, 2)  # a plane and two 12x24 spheres
    p, i = soup["position"], soup["indices"]
    return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


def _tied_soup():
    """750 random triangles, each twice: every hit is an exact tie between
    two rows, next to each other in the leaf order (within one cluster, or
    across two where a cluster boundary falls between them)."""
    return tuple(np.concatenate([v, v]) for v in _soup(4, t=750))


SCENES = {"soup": _soup, "tracer": _tracer_tris, "tied": _tied_soup}
CLUSTERS = (37, 64, 128, 512, 1024)  # build(cluster=) sizes beside the default


def _cluster_kw(cluster):
    return {} if cluster is None else {"cluster": cluster}


@pytest.mark.parametrize("name,cluster", [("soup", None), ("tracer", None)]
                         + [("soup", c) for c in CLUSTERS],
                         ids=["soup", "tracer"] + [f"soup-c{c}" for c in CLUSTERS])
def test_builds_match_reference(name, cluster):
    v0, v1, v2 = SCENES[name]()
    ref, got = jax_bvh.build(v0, v1, v2), bvh.build(v0, v1, v2)
    for f in ("node_min", "node_max", "node_left", "node_start", "node_count",
              "v0", "v1", "v2", "tri_index"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), f)
    kw = _cluster_kw(cluster)
    ref_s, got_s = jax_sweep.build(v0, v1, v2, **kw), sweep.build_arrays(v0, v1, v2, **kw)
    assert got_s["num_tris"] == ref_s.num_tris
    scene = sweep.sweep_scene_from_numpy(got_s, "cpu")
    assert scene.cluster == ref_s.cluster == (cluster or sweep.CLUSTER)
    assert scene.n_clusters == ref_s.n_clusters
    for f in ("g_cluster", "v0e1e2", "tri_id", "cl_min", "cl_max"):
        np.testing.assert_array_equal(got_s[f], np.asarray(getattr(ref_s, f)), f)
    # the grid kernel's tables are the same rows, cluster-major
    gc = got_s["g_cluster"].transpose(1, 0, 2).reshape(40, -1)
    np.testing.assert_array_equal(gc[:24], np.asarray(ref_s.g_side))
    np.testing.assert_array_equal(gc[24:], np.asarray(ref_s.g_plane))


def test_slab_entry_plain_matches_reference():
    v0, v1, v2 = _soup(7, t=1500)
    ref_scene = jax_sweep.build(v0, v1, v2)
    rng = np.random.default_rng(9)
    rpad = sweep.RAY_BLOCK
    o = rng.uniform(-8, 8, (rpad, 3)).astype(np.float32)
    d = rng.normal(size=(rpad, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 1] = 0.0  # axis-parallel rays take the 1e12 branch
    tmax = np.full(rpad, np.inf, np.float32)
    tmax[::5] = -1.0  # dead rays, as the tracer sends them
    m = np.cross(o, d)
    z = np.zeros((rpad, 1), np.float32)
    feats = np.concatenate([d, m, z, z, o, z + 1, d, z], 1).astype(np.float32)
    want = np.asarray(jax_sweep._slab_entry_sub(ref_scene, jnp.asarray(feats),
                                                jnp.asarray(tmax), rpad))
    got = sweep.slab_entry_plain(torch.from_numpy(feats), torch.from_numpy(tmax),
                                 torch.from_numpy(np.asarray(ref_scene.cl_min)),
                                 torch.from_numpy(np.asarray(ref_scene.cl_max))).numpy()
    fin = np.isfinite(want)
    assert fin.mean() > 0.5
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def _rays(name, rng, r=3000):
    """Random rays for the soup; for the tracer scene, camera rays and
    incoherent rays leaving points above the plane, as bounces send."""
    if name in ("soup", "tied"):
        o = rng.uniform(-8, 8, (r, 3))
        d = rng.normal(size=(r, 3))
    else:
        n = r // 2
        target = rng.uniform([-4, 0, -3], [4, 2, 3], (n, 3))
        o = np.concatenate([np.tile([[0.0, 4.0, 9.0]], (n, 1)),
                            rng.uniform([-6, 1e-3, -4], [6, 2, 4], (r - n, 3))])
        d = np.concatenate([target - o[:n], rng.normal(size=(r - n, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


CASES = {  # (any_hit, active, t_max)
    "closest": (False, False, False),
    "closest_active": (False, True, False),
    "any_active": (True, True, False),
    "closest_tmax": (False, False, True),
}


def _sorted_index(scene, tri):
    """Row of each original triangle id in the scene's leaf order."""
    ids = scene.tri_id.numpy()
    where = np.empty(ids.max() + 1, np.int64)
    where[ids[ids >= 0]] = np.nonzero(ids >= 0)[0]
    return where[tri]


def _check_intersect(name, case, sort_rays=False, cluster=None, port_dma=None):
    """The port's ``intersect`` against the reference's on the same rays.
    ``port_dma``: a tuple of ``DMA_SWEEP`` settings, the port run once with
    each (B5, B6) against the one reference result; None: as set."""
    v0, v1, v2 = SCENES[name]()
    ref_scene = jax_sweep.build(v0, v1, v2, **_cluster_kw(cluster))
    scene = sweep.build(v0, v1, v2, device="cpu", **_cluster_kw(cluster))
    rng = np.random.default_rng(11)
    o, d = _rays(name, rng)
    any_hit, use_active, use_tmax = CASES[case]
    active = rng.random(len(o)) > 0.3
    t_max = rng.uniform(1.0, 12.0, len(o)).astype(np.float32)
    jkw = dict(any_hit=any_hit, active=jnp.asarray(active) if use_active else None,
               t_max=jnp.asarray(t_max) if use_tmax else None, sort_rays=sort_rays)
    tkw = dict(any_hit=any_hit, active=torch.from_numpy(active) if use_active else None,
               t_max=torch.from_numpy(t_max) if use_tmax else None, sort_rays=sort_rays)
    want = {k: np.asarray(v) for k, v in
            jax_sweep.intersect(ref_scene, jnp.asarray(o), jnp.asarray(d), **jkw).items()}
    assert 0.1 < want["hit"].mean() < 0.95
    dma_was = sweep.DMA_SWEEP
    try:
        for dma in port_dma or (dma_was,):
            sweep.DMA_SWEEP = dma
            got = {k: v.numpy() for k, v in sweep.intersect(
                scene, torch.from_numpy(o), torch.from_numpy(d), **tkw).items()}
            _compare_intersect(scene, got, want, active if use_active else None,
                               t_max if use_tmax else None)
    finally:
        sweep.DMA_SWEEP = dma_was


def _compare_intersect(scene, got, want, active, t_max):
    assert (got["hit"] == want["hit"]).mean() >= 0.999
    both = got["hit"] & want["hit"]
    assert (got["tri"][both] == want["tri"][both]).mean() >= 0.999
    same = both & (got["tri"] == want["tri"])
    err = np.abs(got["t"][same] - want["t"][same])
    assert (err <= 1e-5 * np.maximum(1.0, np.abs(want["t"][same]))).all(), err.max()
    # u and v: the hit point they give, |du| * (longest edge), within 1e-5
    # of the distance travelled (the refinement solves for them from
    # origin - v0, so their rounding grows with t over the triangle's size)
    e = scene.v0e1e2.numpy()[_sorted_index(scene, want["tri"][same])]
    size = np.maximum(np.linalg.norm(e[:, 3:6], axis=1), np.linalg.norm(e[:, 6:9], axis=1))
    for k in ("u", "v"):
        err = np.abs(got[k][same] - want[k][same]) * size
        assert (err <= 1e-5 * np.maximum(1.0, want["t"][same])).all(), (k, err.max())
    if active is not None:
        assert not got["hit"][~active].any()
    if t_max is not None:
        assert (got["t"][got["hit"]] <= t_max[got["hit"]] * (1 + 1e-5)).all()


# intersect at other cluster sizes: (case, cluster), each on the soup and on
# the tied soup (the same triangle count, so the reference compiles once)
CLUSTER_CASES = [(case, c) for c in (37, 128, 512) for case in ("closest", "any_active")]
SOUP_CASES = dict(argnames="case,cluster",
                  argvalues=[(case, None) for case in CASES] + CLUSTER_CASES,
                  ids=list(CASES) + [f"{case}-c{c}" for case, c in CLUSTER_CASES])


@pytest.mark.parametrize(**SOUP_CASES)
def test_intersect_matches_reference_soup(case, cluster):
    _check_intersect("soup", case, cluster=cluster)
    if cluster is not None:
        _check_intersect("tied", case, cluster=cluster)


@pytest.mark.parametrize("case", ["closest_active", "any_active"])
def test_intersect_matches_reference_tracer_scene(case):
    _check_intersect("tracer", case)


@pytest.fixture
def reference_grid_kernel(monkeypatch):
    """The reference's dense (block, cluster) grid kernel (B6) in place of
    its DMA walk; its jitted intersect is traced anew on both sides."""
    monkeypatch.setattr(jax_sweep, "DMA_SWEEP", False)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("case", ["closest", "any_active"])
def test_intersect_matches_reference_grid_kernel(reference_grid_kernel, case):
    _check_intersect("soup", case)


@pytest.fixture
def port_grid_kernel(reference_grid_kernel, monkeypatch):
    """Both packages on their grid kernels (B6): ``DMA_SWEEP`` off."""
    monkeypatch.setattr(sweep, "DMA_SWEEP", False)
    yield


@pytest.mark.parametrize(**SOUP_CASES)
def test_grid_intersect_matches_reference_grid_kernel(port_grid_kernel, case, cluster):
    _check_intersect("soup", case, cluster=cluster)
    if cluster is not None:
        _check_intersect("tied", case, cluster=cluster)


def test_sweep_cluster_environment_sets_the_default():
    """``SAILOR_SWEEP_CLUSTER=128``, read at import by both packages, in a
    fresh process (``tests/torch_sweep_cluster_env.py`` says what it
    checks)."""
    env = {**os.environ, "SAILOR_SWEEP_CLUSTER": "128", "JAX_PLATFORMS": "cpu"}
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, os.path.join(here, "torch_sweep_cluster_env.py")],
                         cwd=os.path.dirname(here), env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "cluster=128 " in out.stdout and "render close=" in out.stdout, out.stdout


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_sweep_grid_plain_equals_sweep_plain(any_hit):
    """B6's twin walks every step, B5's stops early: the same t bits, ids
    and work on the tracer scene's camera and bounce rays, some dead."""
    v0, v1, v2 = _tracer_tris()
    scene = sweep.build(v0, v1, v2, device="cpu")
    rng = np.random.default_rng(12)
    o, d = _rays("tracer", rng, r=4000)
    active = torch.from_numpy(rng.random(len(o)) > 0.2)
    p = sweep.prepare(scene, torch.from_numpy(o), torch.from_numpy(d), active=active)
    w5, w6 = {}, {}
    t5, i5 = sweep.sweep_plain(p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"],
                               p["tmax"], scene.g_cluster, any_hit=any_hit, work=w5)
    t6, i6 = sweep.sweep_grid_plain(p["e_bits"], p["order"], p["feats"], p["tmax"],
                                    scene.g_cluster, any_hit=any_hit, work=w6)
    assert (i5 >= 0).sum() > 500
    assert torch.equal(i6, i5)
    assert torch.equal(t6.view(torch.int32), t5.view(torch.int32))
    assert w6 == w5


@pytest.mark.parametrize("name,case", [("soup", "closest"), ("soup", "any_active"),
                                       ("soup", "closest_tmax"),
                                       ("tracer", "closest_active")])
def test_intersect_sort_rays_matches_reference(name, case):
    _check_intersect(name, case, sort_rays=True)


def test_ray_order_sorts_by_first_cluster_and_direction():
    """``ray_order`` is a stable sort by first cluster * 64 + direction
    code, and its inverse undoes it; rays that enter no cluster (and the
    padding) sort last."""
    v0, v1, v2 = _tracer_tris()
    scene = sweep.build(v0, v1, v2, device="cpu")
    o, d = _rays("tracer", np.random.default_rng(2), r=3000)
    po, pd, tmax = sweep._pad_rays(torch.from_numpy(o), torch.from_numpy(d), None, None)
    perm, inv = sweep.ray_order(scene, po, pd, tmax)
    n = po.shape[0]
    assert torch.equal(perm[inv], torch.arange(n))
    # the key, recomputed in numpy float32 from the reference's formulas
    on, dn, tm = po.numpy(), pd.numpy(), tmax.numpy()
    lo, hi = scene.cl_min.numpy(), scene.cl_max.numpy()
    with np.errstate(divide="ignore"):
        inv_d = np.where(np.abs(dn) > 1e-12, np.float32(1) / dn, np.float32(1e12))
    a = inv_d[:, None, :] * lo[None] - (on * inv_d)[:, None, :]
    b = inv_d[:, None, :] * hi[None] - (on * inv_d)[:, None, :]
    tn, tf = np.minimum(a, b).max(2), np.maximum(a, b).min(2)
    hit = (tn <= np.minimum(tf, tm[:, None])) & (tf > 0)
    fc = np.where(hit.any(1), np.where(hit, tn, np.inf).argmin(1), scene.n_clusters)
    qd = np.clip(((dn + 1) * 2).astype(np.int32), 0, 3)
    key = fc * 64 + (qd[:, 0] * 4 + qd[:, 1]) * 4 + qd[:, 2]
    np.testing.assert_array_equal(perm.numpy(), np.argsort(key, kind="stable"))
    assert (fc[3000:] == scene.n_clusters).all() and 0 < (fc < scene.n_clusters).mean() < 1


MAPPING_CASES = ([(any_hit, share, None) for share in (0.0, 0.05, 0.5, 1.0)
                  for any_hit in (False, True)]
                 + [(any_hit, share, c) for c, share in ((37, 1.0), (512, 0.5))
                    for any_hit in (False, True)])


@pytest.mark.parametrize("any_hit,share,cluster", MAPPING_CASES,
                         ids=[f"{'any' if a else 'closest'}-{s}" + (f"-c{c}" if c else "")
                              for a, s, c in MAPPING_CASES])
def test_kernel_mapping_matches_sweep_plain(any_hit, share, cluster):
    """The kernels' mapping equals ``sweep_plain`` (t bits, ids) on the
    tracer scene's rays with ``share`` of them active; sub-block 0 then has
    exactly 1 live ray and sub-block 1 has 33. Every live ray of a walked
    pair is packed: for closest hit, ``cluster`` tests each. At cluster 37
    a step is one chunk of 37 columns, at 512 two whole chunks (the tied
    clusters then tie columns across the chunks too)."""
    v0, v1, v2 = _tracer_tris()
    scene = sweep.build(v0, v1, v2, device="cpu", **_cluster_kw(cluster))
    rng = np.random.default_rng(13)
    o, d = _rays("tracer", rng, r=2 * sweep.RAY_BLOCK)
    active = rng.random(len(o)) < share
    if share > 0:
        active[0:2 * sweep.SUB] = False
        active[0] = True
        active[sweep.SUB:sweep.SUB + 33] = True
    p = sweep.prepare(scene, torch.from_numpy(o), torch.from_numpy(d),
                      active=torch.from_numpy(active))
    for g in (scene.g_cluster, tied_clusters(scene.g_cluster)):
        work = {}
        t, i = sweep.sweep_plain(p["e_bits"], p["order"], p["blk_bits"], p["nlive"], p["feats"],
                                 p["tmax"], g, any_hit=any_hit, work=work)
        t_m, i_m, live = packed_walk(p, g, any_hit=any_hit)
        assert torch.equal(i_m, i)
        assert torch.equal(t_m.view(torch.int32), t.view(torch.int32))
        assert int((i >= 0).sum()) >= 0.2 * active.sum()
        if not any_hit:
            assert live * scene.cluster == work["tests"]
    if share == 0:
        assert live == 0 and not bool((i >= 0).any())
    if not any_hit and share >= 0.5:
        col = i[i >= 0] % scene.cluster  # the tied runs: the larger column wins every tie
        if scene.cluster == 256:
            assert not bool(((col < 32) | (col == 128)).any())
            assert bool(((col >= 32) & (col < 64)).any())
        elif scene.cluster == 512:  # columns 0, 32 and 256 tie: the later chunk's wins
            assert not bool(((col < 64) | (col == 128)).any())
            assert bool(((col >= 256) & (col < 288)).any())


def _reference_tables(e_sub, nb):
    """The reference's visit tables from its entries, as ``intersect``
    builds them after ``_slab_entry_sub``."""
    nsb, nc = e_sub.shape
    e_blk = jnp.min(e_sub.reshape(nb, nsb // nb, nc), axis=1)
    order = jnp.argsort(e_blk, axis=1).astype(jnp.int32)
    e_sub_p = jnp.take_along_axis(e_sub.reshape(nb, nsb // nb, nc), order[:, None, :], axis=2)
    blk_sorted = jnp.take_along_axis(e_blk, order, axis=1)
    return {
        "e_bits": np.asarray(jax.lax.bitcast_convert_type(e_sub_p, jnp.int32)).reshape(nsb, nc),
        "order": np.asarray(order),
        "blk_bits": np.asarray(jax.lax.bitcast_convert_type(blk_sorted, jnp.int32)),
        "nlive": np.asarray(jnp.sum(jnp.isfinite(blk_sorted), axis=1).astype(jnp.int32)),
    }


@pytest.mark.parametrize("name", ["soup", "tracer", "soup_c32"])
def test_visit_tables_match_reference(name):
    """B4's tables (``tables_from_entries``) built from the reference's own
    entries (``_slab_entry_sub``, interpret mode) equal the reference's
    tables exactly: order and nlive, and e_bits and blk_bits bit for bit, on
    the soup's and the tracer scene's rays, dead ones included. The whole
    plain path (``visit_tables_plain``) equals them where the port's entries
    equal the reference's bit for bit (the soup: checked here); on the
    tracer rays the reference's compiled slab contracts some products into
    the following subtraction, which ``test_slab_entry_plain_matches_reference``
    bounds. ``soup_c32``: 40,000 triangles in clusters of 32, 1,250
    clusters (more than B4 once took); there the reference's compiled slab
    contracts products too, so the plain path's entries are held to one
    float32 ulp of the subtraction's operands (|ref| plus the sub-block's
    largest |o * inv|), finiteness exactly, and its tables equal those of
    its own entries (``tables_from_entries``, exact above)."""
    if name == "soup_c32":
        v0, v1, v2 = _soup(7, t=40000)
        ref_scene = jax_sweep.build(v0, v1, v2, cluster=32)
        assert ref_scene.n_clusters == 1250
    else:
        v0, v1, v2 = SCENES[name]() if name == "tracer" else _soup(7, t=1500)
        ref_scene = jax_sweep.build(v0, v1, v2)
    rng = np.random.default_rng(21)
    rpad = 2 * sweep.RAY_BLOCK
    o, d = _rays(name if name == "tracer" else "soup", rng, r=rpad)
    tmax = np.full(rpad, np.inf, np.float32)
    tmax[::5] = -1.0
    tmax[sweep.RAY_BLOCK:] = -1.0  # a block of dead rays outside every box
    o[sweep.RAY_BLOCK:] += np.float32(100.0)
    m = np.cross(o, d)
    z = np.zeros((rpad, 1), np.float32)
    feats = np.concatenate([d, m, z, z, o, z + 1, d, z], 1).astype(np.float32)
    e_ref = jax_sweep._slab_entry_sub(ref_scene, jnp.asarray(feats), jnp.asarray(tmax), rpad)
    want = _reference_tables(e_ref, rpad // sweep.RAY_BLOCK)
    assert want["nlive"][0] > 0 and want["nlive"][1] == 0
    got = sweep.tables_from_entries(torch.from_numpy(np.asarray(e_ref)))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)
    if name == "soup_c32":
        plain = sweep.visit_tables_plain(
            torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
            torch.from_numpy(np.asarray(ref_scene.cl_min)),
            torch.from_numpy(np.asarray(ref_scene.cl_max)))
        np.testing.assert_array_equal(plain["feats"].numpy(), feats)
        got_e, want_e = sub_entries(plain).view(torch.float32).numpy(), np.asarray(e_ref)
        fin = np.isfinite(want_e)
        assert 0.2 < fin.mean() < 0.8
        np.testing.assert_array_equal(np.isfinite(got_e), fin)
        scale = np.abs(o * np.float32(1) / d).max(1)  # no axis-parallel ray here
        scale = np.where(tmax > 0, scale, 0).reshape(-1, sweep.SUB).max(1)
        err = np.abs(np.where(fin, got_e, 0) - np.where(fin, want_e, 0))
        assert (err <= 2.0 ** -23 * (np.abs(np.where(fin, want_e, 0)) + scale[:, None])).all()
        mine = sweep.tables_from_entries(sub_entries(plain).view(torch.float32))
        for k in ("e_bits", "order", "blk_bits", "nlive"):
            assert torch.equal(plain[k], mine[k]), k
    if name == "soup":
        plain = sweep.visit_tables_plain(
            torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax),
            torch.from_numpy(np.asarray(ref_scene.cl_min)),
            torch.from_numpy(np.asarray(ref_scene.cl_max)))
        np.testing.assert_array_equal(plain["feats"].numpy(), feats)
        np.testing.assert_array_equal(sub_entries(plain).numpy(),
                                      np.asarray(e_ref).view(np.int32))
        for k, v in want.items():
            np.testing.assert_array_equal(plain[k].numpy(), v, k)


def test_rank_order_matches_stable_argsort():
    """The kernel's visit order by rank (``chip_smoke.visit_order``) equals
    ``torch.argsort(stable=True)`` of the block entries on crafted rows:
    finite entries tied in runs, a row of +inf only, +0 entries (tied with
    each other and ahead of every positive one), and a mixed random row."""
    inf = float("inf")
    rows = torch.tensor([
        [3.0, 1.0, 3.0, 1.0, 2.0, 3.0, 1.0, 0.5],
        [inf] * 8,
        [0.0, 2.0, 0.0, inf, 0.0, 1e-30, inf, 0.0],
        [inf, 4.0, inf, 4.0, 0.0, inf, 4.0, 7.0],
    ], dtype=torch.float32)
    rng = np.random.default_rng(5)
    mixed = rng.choice([0.0, 0.25, 1.5, 1.5, np.inf], size=(1, 8)).astype(np.float32)
    rows = torch.cat([rows, torch.from_numpy(mixed)])
    want = torch.argsort(rows, dim=1, stable=True)
    assert torch.equal(visit_order(rows.view(torch.int32)), want)
    # the same order from the tables' builder (one sub-block row a block)
    e_sub = rows.repeat_interleave(sweep.RAY_BLOCK // sweep.SUB, 0)
    tables = sweep.tables_from_entries(e_sub)
    assert torch.equal(tables["order"], want.to(torch.int32))
    assert torch.equal(tables["nlive"], torch.isfinite(rows).sum(1).to(torch.int32))
