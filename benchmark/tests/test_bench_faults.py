"""A run of each cell with the timed path broken underneath must come out
not correct, and a sound run correct: the harness's look for a chip is
skipped and the rest of a run is driven on the CPU at a small size. The
faults a renderer can have: an answer altered where it is produced (the
frame's Final, the render's image) and half of the batch left out (half
of the shaded tiles, half of an intersector pass's rays)."""

import contextlib

import pytest
import torch
from conftest import small

from benchmark.harness import cell


def _run(workload):
    return cell.run(workload, 987654321987, 0.0, False, device="cpu",
                    overrides=small(workload))


@contextlib.contextmanager
def patched(module, name, wrap):
    inner = getattr(module, name)
    setattr(module, name, wrap(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


@pytest.mark.parametrize("workload", ["queues-1080p.still", "tracer-512.pooled"])
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_final_altered_where_produced():
    from sailor_tpu_torch.framegraph.graph import node_types

    cls = node_types()["EyeAdaptation"]

    def wrap(inner):
        def process(self, ctx, targets):
            out = inner(self, ctx, targets)
            out["Final"] = out["Final"].clone()
            out["Final"][3, 5] += 0.25
            return out
        return process

    with patched(cls, "process", wrap):
        out = _run("queues-1080p.still")
    assert not out["correct"] and out["compared"]["final_gap"]["value"] > 0.2


def test_half_the_shaded_tiles_left_out():
    from sailor_tpu_torch.kernels import pbr_kernel

    def wrap(inner):
        def shade(*args, **kwargs):
            out = inner(*args, **kwargs).clone()
            out[: out.shape[0] // 2] = 0.0
            return out
        return shade

    with patched(pbr_kernel, "shade_forward_plus_kernel", wrap):
        out = _run("queues-1080p.still")
    assert not out["correct"] and out["compared"]["shade_gap"]["value"] > 0.5


def test_image_altered_where_produced():
    from sailor_tpu_torch.raytracing import path_tracer

    def wrap(inner):
        def render_cached(*args, **kwargs):
            img, rays = inner(*args, **kwargs)
            return img * 1.01, rays
        return render_cached

    with patched(path_tracer, "render_cached", wrap):
        out = _run("tracer-512.pooled")
    assert not out["correct"] and out["compared"]["image_px_off"]["value"] > 0.5


def test_half_of_a_pass_left_out():
    from sailor_tpu_torch.raytracing import path_tracer

    def wrap(inner):
        def isect(*args, **kwargs):
            res = dict(inner(*args, **kwargs))
            half = res["hit"].shape[0] // 2
            res["hit"] = res["hit"].clone()
            res["hit"][half:] = False
            return res
        return isect

    with patched(path_tracer, "_isect", wrap):
        out = _run("tracer-512.pooled")
    assert not out["correct"] and out["compared"]["isect_t_off"]["value"] > 0.1


def test_hit_on_another_triangle():
    """A pass that names a triangle the ray does not meet, at the right t."""
    from sailor_tpu_torch.raytracing import path_tracer

    def wrap(inner):
        def isect(*args, **kwargs):
            res = dict(inner(*args, **kwargs))
            res["tri"] = torch.where(res["hit"], res["tri"] ^ 1, res["tri"])  # its neighbour
            return res
        return isect

    with patched(path_tracer, "_isect", wrap):
        out = _run("tracer-512.pooled")
    assert not out["correct"] and out["compared"]["isect_t_off"]["value"] > 0.1


def test_a_transparent_layer_left_out():
    """RenderTransparent peels one layer fewer than the configuration
    states: the farthest layer's pixels are missing."""
    from sailor_tpu_torch.framegraph import nodes

    def wrap(inner):
        def transparent_raster(ctx):
            tri, aabb, raster_t, sb = inner(ctx)
            calls = []

            def peel(bounds):
                calls.append(1)
                d, t = raster_t(bounds)
                return (d, torch.full_like(t, -1)) if len(calls) % 3 == 0 else (d, t)
            return tri, aabb, peel, sb
        return transparent_raster

    with patched(nodes, "transparent_raster", wrap):
        out = _run("queues-1080p.still")
    assert not out["correct"] and out["compared"]["transparent_layer_off"]["value"] > 0.05


@pytest.mark.parametrize("workload", ["queues-1080p.still", "tracer-512.pooled"])
def test_control_is_not_correct(workload):
    """The control: the reference in bfloat16 in the program's place fails
    at least one limit (the same comparison on the card is recorded in
    PERF.md at the cells' own sizes)."""
    from benchmark.harness import manifest

    c = manifest.cell(workload)
    for k, v in small(workload).items():
        (c.traffic if k == "traffic" else c.config[k]).update(v)
    drv, check = c.driver(), c.check()
    s = drv.setup(c, 1357, "cpu")
    drv.window_run(s, 0.0)
    numbers = check.control(s.capture, s.host, "cpu", c.config.get("settings", {}),
                            dtype=torch.bfloat16)
    assert any(not (numbers[k] <= lim) for k, lim in check.LIMITS.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["queues-1080p.still", "tracer-512.pooled"])
def test_control_is_not_correct_on_the_card(card, workload):
    """The control at the cell's own size on the card."""
    from benchmark.harness import manifest

    c = manifest.cell(workload)
    drv, check = c.driver(), c.check()
    s = drv.setup(c, 24680, "cuda")
    drv.window_run(s, 0.0)
    drv.release(s)
    numbers = check.control(s.capture, s.host, "cuda", c.config.get("settings", {}))
    assert any(not (numbers[k] <= lim) for k, lim in check.LIMITS.items()), numbers
