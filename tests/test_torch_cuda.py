"""Card tests: each CUDA kernel against its plain PyTorch version on the
card, and a frame on the card against the same frame on the CPU path.

Marked ``cuda``; every test skips at run time when torch sees no CUDA
device (the decision is made inside a fixture, so every worker collects the
same tests). On a machine with the card and nvcc:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which these tests do
not use; ``-o addopts=""``: no xdist workers.)

Inputs: the flagship scene at 640x384 (64 point lights, 24 objects) and
the kernel inputs its own nodes make. Tolerances, from the arithmetic:
- raster: depth and ids exact (the plain version's fma emulation rounds
  like the kernel's fmaf);
- resolve: exact on >= 99.999% of values (the same operations in the same
  order; the float64 fma emulation can double-round in ~2^-29 of cases),
  and every value within 1e-4 * (1 + |plain|), so a wrong row fails;
- shade: 1e-5 relative (same order; rsqrt may differ by an ulp).
"""

import pytest
import torch

from chip_smoke import check_small_frame, frame_inputs
from sailor_tpu_torch.kernels import cuda_lib, pbr_kernel
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.scenes import flagship_scene

pytestmark = pytest.mark.cuda
W, H = 640, 384


@pytest.fixture(scope="module")
def card_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cuda_lib.load()
    scene = flagship_scene(W, H, 64, 24)
    return scene, frame_inputs(scene, W, H)


@pytest.mark.parametrize("bounded", [False, True], ids=["no_bounds", "z_bounds"])
def test_raster_kernel_matches_plain(card_frame, bounded):
    _, (sb, targets, *_rest, tiles_y, tiles_x) = card_frame
    args = (sb["rows"], sb["big_rows"], sb["starts"], sb["counts"], sb["n_big"])
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, chunk=128)
    if bounded:
        d0, t0 = tr.rasterize_worklist_cuda(*args, **kw)
        kw["z_bounds"] = (torch.zeros_like(d0), torch.where(t0 >= 0, d0, 2.0))
    before = cuda_lib.LAUNCHES["raster_worklist"]
    d_k, t_k = tr.rasterize_worklist_cuda(*args, **kw)
    assert cuda_lib.LAUNCHES["raster_worklist"] == before + 1
    d_p, t_p = tr.rasterize_worklist_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((t_p >= 0).sum()) > 100
    assert torch.equal(t_k, t_p)
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("na,mode", [(37, "full"), (49, "full"), (49, "alpha")])
def test_resolve_kernel_matches_plain(card_frame, na, mode):
    scene, (sb, targets, inv_vp, _gb, tiles_y, tiles_x) = card_frame
    rows, big = sb["rows"], sb["big_rows"]
    if na == 49:
        gen = torch.Generator(device=rows.device).manual_seed(5)
        rows, big = (torch.cat([r, torch.rand(len(r), 12, device=r.device, generator=gen)], 1)
                     for r in (rows, big))
    tid = tr.rasterize_worklist_cuda(rows.contiguous(), big.contiguous(), sb["starts"],
                                     sb["counts"], sb["n_big"], tiles_y=tiles_y,
                                     tiles_x=tiles_x)[1]
    par = tr._resolve_params(inv_vp, scene.frame.camera_position, W, H, 0, rows.device)
    kw = dict(tiles_y=tiles_y, tiles_x=tiles_x, na=na, chunk=int(sb["chunk"]), mode=mode)
    args = (rows.contiguous(), big.contiguous(), tid, sb["starts"], sb["counts"], par)
    got = torch.stack(tr.resolve_worklist_cuda(*args, **kw))
    ref = torch.stack(tr.resolve_worklist_plain(*args, **kw))
    assert got.shape[0] == {"full": 13 if na == 37 else 29, "alpha": 5}[mode]
    assert (got == ref).float().mean().item() >= 1 - 1e-5
    assert bool(((got - ref).abs() <= 1e-4 * (1 + ref.abs())).all())
    assert not got[:, tid < 0].any()


def test_shade_kernel_matches_plain(card_frame):
    scene, (sb, targets, inv_vp, gb, tiles_y, tiles_x) = card_frame
    lp = pbr_kernel.pack_tile_lights(scene.lights, targets["LightIndices"])
    args = (lp, targets["LightCounts"].to(torch.int32).contiguous(), gb.albedo.contiguous(),
            gb.metallic.contiguous(), gb.roughness.contiguous(), gb.normal.contiguous(),
            gb.world_position.contiguous(), None,
            scene.frame.camera_position.to(torch.float32).contiguous())
    got = pbr_kernel.shade_tiles_cuda(*args)
    ref = pbr_kernel.shade_tiles_plain(*args)
    assert ref.abs().max().item() > 0.1
    rel = ((got - ref).abs() / ref.abs().clamp(min=1e-3)).max().item()
    assert rel <= 1e-5, rel


def test_frame_on_card_matches_cpu(card_frame):
    check_small_frame()
