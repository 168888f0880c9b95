"""The work counts behind chip_smoke.py's bounds, checked on the CPU.

``raster_work`` counts the (pixel, candidate) pairs the raster must test
from the rows' AABB columns in closed form; here it is held, exactly, to
a brute-force count that applies the raster's own float32 AABB test to
every pixel of every tile (256x128 flagship frame, CPU path).
"""

import pytest
import torch

import chip_smoke
from sailor_tpu_torch.raster import tile_raster as tr
from sailor_tpu_torch.scenes import flagship_scene

W, H = 256, 128


def _brute_pairs(blocks, tiles_x):
    """blocks: per tile, its (C, >=17) candidate rows."""
    pairs = 0
    for t, q in enumerate(blocks):
        q = q[q[:, 16] >= 0]
        px, py = tr._tile_pixels(t, tiles_x, "cpu")
        ok = ((px >= q[:, 12:13] + tr.EPS) & (px <= q[:, 13:14] - tr.EPS)
              & (py >= q[:, 14:15] + tr.EPS) & (py <= q[:, 15:16] - tr.EPS))
        pairs += int(ok.sum())
    return pairs


@pytest.fixture(scope="module")
def frame_rows():
    scene = flagship_scene(W, H, 24, 10, device="cpu")
    sb, *_, tiles_y, tiles_x = chip_smoke.frame_inputs(scene, W, H)
    return sb, tiles_y, tiles_x


@pytest.mark.parametrize("source", ["tile_rows", "big_list"])
def test_raster_work_counts_aabb_pairs(frame_rows, source):
    sb, tiles_y, tiles_x = frame_rows
    rows, starts, counts = sb["rows"], sb["starts"], sb["counts"]
    ntiles = tiles_y * tiles_x
    if source == "tile_rows":
        big, n_big = sb["big_rows"], sb["n_big"]
        segments = [rows[s:s + c] for s, c in zip(starts.tolist(), counts.tolist())]
        blocks = [torch.cat([seg, big[:int(n_big)]]) for seg in segments]
        live_rows = segments + [big[:int(n_big)]]
    else:  # some live rows as a big list (and a dead row), tested at every tile
        live = rows[rows[:, 16] >= 0][:64]
        big, n_big = torch.cat([live, rows[-1:]]), torch.tensor(65)
        starts = counts = torch.zeros(ntiles, dtype=torch.int32)
        blocks, live_rows = [live] * ntiles, [live]
    cand, pairs = chip_smoke.raster_work(rows, big, starts, counts, n_big,
                                         tiles_y, tiles_x)
    assert cand == sum(int((r[:, 16] >= 0).sum()) for r in live_rows)
    expected = _brute_pairs(blocks, tiles_x)
    assert expected > 1000
    assert pairs == expected
