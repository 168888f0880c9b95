"""Measure the HiZ cull's culled visible triangles in both packages.

Not collected by pytest. Renders the shadowed, HiZ-culled graph
(``SHADOW_HIZ_GRAPH``, ``shadow_resolution`` 128) on the reference's
flagship scene for two frames with a static camera in the JAX package (its
shade kernel with exact division, as the parity tests run it) and in the
port on the CPU, and prints each frame's HiZCulledCount, the pixels where
the port's Depth and TriId differ from the reference's, and the pixels
where frame 2 differs from frame 1 in each package: a triangle whose
raster depth passes its vertex maximum (the raster accepts pixel centres
up to 0.05 px outside the edges) is culled by its own depth in the next
frame's pyramid.

    python tests/torch_hiz_gap.py [WIDTH HEIGHT OBJECTS]   # default 384 256 96

About 2 minutes and under 2 GiB at the default size.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sailor_tpu.framegraph import FrameGraph as JFrameGraph  # noqa: E402
from sailor_tpu.framegraph import FrameGraphAsset as JAsset  # noqa: E402
from sailor_tpu.kernels import pbr_pallas as j_pk  # noqa: E402
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset  # noqa: E402
from test_torch_scenes import (SHADOW_HIZ_CONFIG, SHADOW_HIZ_GRAPH,  # noqa: E402
                               SHADOW_HIZ_VALUES, jax_scene, torch_scene)

KEYS = ("Depth", "TriId", "HiZCulledCount")


def frames(fg, scene, extra=()):
    state = fg.initial_state()
    out = []
    for _ in range(2):
        t, state = fg.process(scene, state)
        out.append({k: np.asarray(t[k]) for k in KEYS})
        out[-1].update({k: t[k] for k in extra})
    return out


def main(width=384, height=256, objects=96):
    config = dict(SHADOW_HIZ_CONFIG, shadow_resolution=128)
    js = jax_scene(width, height, 24, objects)
    j_pk._rcp = lambda x: 1.0 / x
    yaml_text = ("float:\n" + "".join(f"  {k}: {v}\n" for k, v in SHADOW_HIZ_VALUES.items())
                 + "frame:\n" + "".join(f" - name: {n}\n" for n in SHADOW_HIZ_GRAPH))
    t0 = time.perf_counter()
    ref = frames(JFrameGraph(JAsset.from_yaml(yaml_text), width, height, config=dict(config)), js)
    t1 = time.perf_counter()
    got = frames(FrameGraph(FrameGraphAsset.from_nodes(SHADOW_HIZ_GRAPH, SHADOW_HIZ_VALUES),
                            width, height, dict(config), device="cpu"), torch_scene(js),
                 extra=("TriSetup",))
    t2 = time.perf_counter()
    print(f"{width}x{height}, {objects} objects: reference {t1 - t0:.1f} s, port {t2 - t1:.1f} s")
    for i, (r, g) in enumerate(zip(ref, got), 1):
        print(f"frame {i}: HiZCulledCount reference={int(r['HiZCulledCount'])} "
              f"port={int(g['HiZCulledCount'])} depth_px_differing={int((r['Depth'] != g['Depth']).sum())} "
              f"tid_px_differing={int((r['TriId'] != g['TriId']).sum())}")
    tid = got[0]["TriId"]
    zmax = got[0]["TriSetup"].zmax.numpy()[np.maximum(tid, 0)]
    over = (tid >= 0) & (got[0]["Depth"] > zmax)
    print(f"port frame 1: pixels_with_depth_above_winner_zmax={int(over.sum())} of "
          f"{int((tid >= 0).sum())} covered, max_excess="
          f"{float((got[0]['Depth'] - zmax)[over].max()) if over.any() else 0.0:.6g}")
    for name, f in (("reference", ref), ("port", got)):
        moved = (f[0]["Depth"] != f[1]["Depth"]) | (f[0]["TriId"] != f[1]["TriId"])
        print(f"{name}: frame 2 vs frame 1 moved_px={int(moved.sum())} "
              f"culled_visible_triangles={len(np.unique(f[0]['TriId'][moved]))}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
