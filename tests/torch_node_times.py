"""Per-node times of the flagship frame on one card. Not a test; run from
the repo root:

    python tests/torch_node_times.py [--root DIR] [--reps N] [--label L]

The frame is DefaultRenderer.renderer at 1920x1088 on the flagship scene
(``chip_smoke.FLAGSHIP``, ``chip_smoke.FULL_CONFIG``). After two warm-up
frames it times, with the frame graph's ``process_debug`` (a synchronise
after each node), a cached frame and a frame whose shadow cascades are
dirty (the CSM cache dropped from the state, so ShadowPrepass renders and
blurs every cascade), and keeps the least of ``--reps`` runs of each
node; then the least of ``--reps`` whole cached frames through
``process``, timed to a synchronise. ``--root DIR`` imports
``sailor_tpu_torch`` and ``chip_smoke`` from another tree (a ``git
archive`` of another commit, unpacked), so that two versions are
compared in one call. Prints the card's name and power limit, a table,
and one JSON line: {"label", "card", "cached", "dirty", "frame_ms"}.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="tree to import sailor_tpu_torch and chip_smoke from")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke as cs
    from sailor_tpu_torch.kernels import cuda_lib
    from sailor_tpu_torch.scenes import flagship_scene

    if not torch.cuda.is_available():
        print("torch_node_times: no CUDA device", file=sys.stderr)
        return 1
    card = cs._card()
    cuda_lib.load()
    width, height, lights, objects = cs.FLAGSHIP
    scene = flagship_scene(width, height, lights, objects)
    fg = cs._full_graph(width, height)
    state = fg.initial_state()
    for _ in range(2):
        fg.prepare(scene, state)
        state = fg.process(scene, state)[1]
    torch.cuda.synchronize()

    def least(make_state):
        best: dict = {}
        for _ in range(args.reps):
            st = make_state()
            fg.prepare(scene, st)
            _, _, t = fg.process_debug(scene, st)
            for k, v in t.items():
                best[k] = min(v, best.get(k, v))
        return {k: round(v, 3) for k, v in best.items()}

    cached = least(lambda: dict(state))
    dirty = least(lambda: {k: v for k, v in state.items() if not k.startswith("csm/")})
    frame_ms = []
    for _ in range(args.reps):
        st = dict(state)
        fg.prepare(scene, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fg.process(scene, st)
        torch.cuda.synchronize()
        frame_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    label = args.label or os.path.abspath(args.root)
    print(f"card: {card}")
    print(f"{'node':40s} {'cached ms':>10s} {'dirty ms':>10s}")
    for k in cached:
        print(f"{k:40s} {cached[k]:10.3f} {dirty.get(k, float('nan')):10.3f}")
    print(f"frame (process, cached): {frame_ms} ms")
    print(json.dumps({"label": label, "card": card, "cached": cached, "dirty": dirty,
                      "frame_ms": frame_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
