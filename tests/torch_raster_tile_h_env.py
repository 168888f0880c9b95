"""Run by ``tests/test_torch_raster_tile_h.py`` with
``SAILOR_RASTER_TILE_H=32`` in its environment (not collected): both
packages read the height at import, so it needs a process of its own.

Checks that both packages' ``tile_raster.TILE_H`` is the environment's and
that a 128x64 frame of the minimal Forward+ graph (the flagship scene, 24
lights, 10 objects; the reference's approximate reciprocal made exact and
its inverse view-projection handed to the port, as in
``test_torch_frame.py``) through each package's ``FrameGraph.process``
meets that test's bars: Depth, TriId and the light lists equal, Main
within 1e-4 relative on >= 99.9% of pixels, Final within 2/255. The
port's ``raster.rasterize`` at 128x64 (capacity 64, 2 rounds) gives the
reference's depth, ids and overflow. Prints one line with the height.

    SAILOR_RASTER_TILE_H=32 JAX_PLATFORMS=cpu python tests/torch_raster_tile_h_env.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # the environment may pre-seed another backend

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sailor_tpu import raster as j_raster  # noqa: E402
from sailor_tpu.framegraph import FrameGraph as JFrameGraph  # noqa: E402
from sailor_tpu.framegraph import FrameGraphAsset as JAsset  # noqa: E402
from sailor_tpu.kernels import pbr_pallas as j_pk  # noqa: E402
from sailor_tpu.raster import tile_raster as j_tr  # noqa: E402
from sailor_tpu_torch import raster as t_raster  # noqa: E402
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset  # noqa: E402
from sailor_tpu_torch.framegraph import nodes as t_nodes  # noqa: E402
from sailor_tpu_torch.raster import tile_raster as t_tr  # noqa: E402
from test_torch_scenes import MINIMAL_GRAPH, SLICE_CONFIG, jax_scene, torch_scene  # noqa: E402

KEYS = ("Depth", "TriId", "LightIndices", "LightCounts", "Main", "Final")


def main() -> int:
    want = int(os.environ["SAILOR_RASTER_TILE_H"])
    assert j_tr.TILE_H == t_tr.TILE_H == want, (j_tr.TILE_H, t_tr.TILE_H)
    w, h = 128, 64
    js = jax_scene(w, h, 24, 10)
    j_pk._rcp = lambda x: 1.0 / x
    fg = JFrameGraph(JAsset.from_yaml("frame:\n" + "".join(f" - name: {n}\n"
                                                           for n in MINIMAL_GRAPH)),
                     w, h, config=dict(SLICE_CONFIG))
    ref = {k: np.asarray(v) for k, v in fg.process(js, fg.initial_state())[0].items()
           if k in KEYS}
    inv = torch.from_numpy(np.array(jnp.linalg.inv(js.frame.view_projection)))
    t_nodes.inverse_view_projection = lambda frame: inv
    ts = torch_scene(js)
    tfg = FrameGraph(FrameGraphAsset.from_nodes(MINIMAL_GRAPH), w, h, SLICE_CONFIG, device="cpu")
    got = {k: np.asarray(v) for k, v in tfg.process(ts, tfg.initial_state())[0].items()
           if k in KEYS}
    assert (ref["TriId"] >= 0).mean() > 0.3
    for k in ("TriId", "Depth", "LightCounts", "LightIndices"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rel = (np.abs(got["Main"] - ref["Main"]) / np.maximum(np.abs(ref["Main"]), 1e-3)).max(-1)
    close = float((rel <= 1e-4).mean())
    assert close >= 0.999, close
    final = float(np.abs(got["Final"] - ref["Final"]).max())
    assert final <= 2 / 255, final

    kw = dict(width=w, height=h, capacity=64, rounds=2)
    _, ref_d, ref_t, ref_stats = j_raster.rasterize(js.geometry, js.frame.view_projection, **kw)
    _, d, t, stats = t_raster.rasterize(ts.geometry, ts.frame.view_projection, device="cpu", **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    assert int(stats["bin_overflow"]) == int(ref_stats["bin_overflow"])
    print(f"tile_h={want}: frame {w}x{h} Main close {close:.6f} Final max {final:.3g}; "
          f"rasterize overflow {int(stats['bin_overflow'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
