"""Two checkouts of the port on one NVIDIA GPU, in turns (A, B, B, A, A,
B), on the same scene: the frame times of the flagship cells that both
checkouts run (1920x1088, 1000 point lights, 96 objects): flagship-minimal
(``MINIMAL_GRAPH``, ``SLICE_CONFIG``), flagship-shadow-hiz's cached frame
(``SHADOW_HIZ_GRAPH``) and flagship-full's cached frame (all of
content/DefaultRenderer.renderer, ``FULL_CONFIG``, ``prepare`` before
each), each checkout with its own chip_smoke.py's graphs and configs. Not
a test (it is not collected): a measurement for comparing a change with
its parent on the cells it should not move.

    python tests/torch_compare_frames.py PATH_A PATH_B

Each run is a fresh process that imports the package of its checkout
(which builds its kernels into its own build/). Per cell: 2 warm-up frames
(the first of the cached cells renders the cascades and the bake), then 5
frames with the state threaded through, each timed on the host clock
around work that ends in ``torch.cuda.synchronize()``. Each run prints one
JSON line of frame ms per cell and the card.
"""

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset
from sailor_tpu_torch.kernels import cuda_lib
from sailor_tpu_torch.scenes import flagship_scene

torch.backends.cuda.matmul.allow_tf32 = False
cuda_lib.load()
w, h, lights, objects = cs.FLAGSHIP
scene = flagship_scene(w, h, lights, objects)
cells = {
    "minimal": FrameGraph(FrameGraphAsset.from_nodes(cs.MINIMAL_GRAPH), w, h,
                          dict(cs.SLICE_CONFIG)),
    "shadow_hiz_cached": FrameGraph(FrameGraphAsset.from_nodes(
        cs.SHADOW_HIZ_GRAPH, cs.SHADOW_HIZ_VALUES), w, h, dict(cs.SHADOW_HIZ_CONFIG)),
    "full_cached": FrameGraph(FrameGraphAsset.load(cs.RENDERER), w, h, dict(cs.FULL_CONFIG)),
}
out = {"checkout": sys.argv[1]}
for name, fg in cells.items():
    state = fg.initial_state()
    times = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fg.prepare(scene, state)
        _, state = fg.process(scene, state)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    out[name + "_ms"] = [round(t, 3) for t in times]
out["card"] = cs._card()
print(json.dumps(out))
'''


def main():
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(p) for p in sys.argv[1:])
    for path in (a, b, b, a, a, b):
        run = subprocess.run([sys.executable, "-c", CHILD, path], cwd=path,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
        if run.returncode:
            print(run.stdout[-4000:], file=sys.stderr)
            return run.returncode
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
