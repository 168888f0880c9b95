"""The dense frame against the work-list frame at the flagship frame's size,
in the JAX package (its frame graph, Pallas in interpret mode) and in the
PyTorch port (plain twins), on the CPU. Both packages render the same
scene (``bench._build_scene``, handed to the port through
``scene_from_numpy``) through the DepthPrepass node alone, once with the
slice's work-list raster and once with ``raster_mode="dense"`` (bin_all's
passes through the dense raster and the depth merge, on the setup the
reference rounds as it does beside ``bin_all``).

Prints, per configuration, whether the port's Depth and TriId equal the
reference's, and per package the dense frame's gap to the work-list
frame's: the largest depth difference, the pixels whose depth differs and
the winners that change where the depths differ. Not a test (it is not
collected): a measurement.

    python tests/torch_dense_gap.py [width height lights objects]

Defaults to the flagship frame (1920 1088 1000 96).
"""

import os
import sys
import time

os.environ.setdefault("SAILOR_AOT_CACHE", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from sailor_tpu.framegraph import FrameGraph as JFrameGraph  # noqa: E402
from sailor_tpu.framegraph import FrameGraphAsset as JAsset  # noqa: E402
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset  # noqa: E402
from test_torch_scenes import SLICE_CONFIG, jax_scene, torch_scene  # noqa: E402

CONFIGS = {"worklist": {}, "dense": {"raster_mode": "dense"}}


def main(width=1920, height=1088, lights=1000, objects=96):
    js = jax_scene(width, height, lights, objects)
    ts = torch_scene(js)
    res = {}
    for name, change in CONFIGS.items():
        config = dict(SLICE_CONFIG, **change)
        t0 = time.time()
        jfg = JFrameGraph(JAsset.from_yaml("frame:\n - name: DepthPrepass\n"), width, height,
                          config=config)
        rt, _ = jfg.process(js, jfg.initial_state())
        res["reference", name] = (np.asarray(rt["Depth"]), np.asarray(rt["TriId"]))
        jax.clear_caches()
        t1 = time.time()
        fg = FrameGraph(FrameGraphAsset.from_nodes(["DepthPrepass"]), width, height, config,
                        device="cpu")
        pt, _ = fg.process(ts, fg.initial_state())
        res["port", name] = (pt["Depth"].numpy(), pt["TriId"].numpy())
        (dr, ir), (dp, ip) = res["reference", name], res["port", name]
        print(f"{name}: port vs reference depth_equal={np.array_equal(dr, dp)} "
              f"tid_equal={np.array_equal(ir, ip)} tid_mismatch={int((ir != ip).sum())} "
              f"(reference {t1 - t0:.1f} s, port {time.time() - t1:.1f} s)", flush=True)
    for who in ("reference", "port"):
        (dw, iw), (dd, idd) = res[who, "worklist"], res[who, "dense"]
        print(f"{who} {width}x{height} dense vs worklist: "
              f"max_depth_diff={np.abs(dd - dw).max():.6g} "
              f"depth_px_differ={int((dd != dw).sum())} tid_mismatch={int((idd != iw).sum())} "
              f"tid_mismatch_untied={int(((idd != iw) & (dd != dw)).sum())}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:5]))
