"""Per-node profile of the Forward+ frame through all of
content/DefaultRenderer.renderer (counterpart of the JAX package's
tools/profile_frame.py).

A ``Renderer`` (engine/app.py) pushes a first frame, then ``--frames``
timed frames with a synchronise after each (the state threaded through,
so the temporal caches hit as they would in an app), then
``Renderer.profile_nodes`` times each node with a synchronise after it
(the least of ``--frames`` runs). ``--trace DIR`` writes one more frame
as a torch.profiler Chrome trace (``DIR/frame.json``).

The reference's ``--eager``, ``--pernode`` and ``--nojit`` choose among
jit strategies that the eager port does not have, and ``--sponza`` needs
a material library the repo does not hold; none is offered here.

Usage:
  python -m sailor_tpu_torch.tools.profile_frame                  # 1920x1088, 1k lights
  python -m sailor_tpu_torch.tools.profile_frame --small          # 640x384
  python -m sailor_tpu_torch.tools.profile_frame --content M.glb  # 60 textured instances
  python -m sailor_tpu_torch.tools.profile_frame --trace DIR      # a Chrome trace too
  python -m sailor_tpu_torch.tools.profile_frame --cpu --small    # the plain twins
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

RENDERER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "content", "DefaultRenderer.renderer")


#: the reference tool's frame graph config
CONFIG = {"z_far": 150.0, "shadow_resolution": 1024, "env_resolution": 32,
          "bin_capacity": 1024, "bin_rounds": 4, "max_lights_per_tile": 128,
          "pallas_shading": True, "fused_resolve": True}
#: the instances of ``--content``'s model, as in the reference's content scene
CONTENT_INSTANCES = 60


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="640x384, 128 lights, 24 objects")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--content", metavar="GLB", default=None,
                    help="instances of this textured model (bench.py --content's scene)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write one frame's torch.profiler Chrome trace into DIR")
    ap.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    args = ap.parse_args(argv)
    if args.frames < 1:
        ap.error("--frames must be at least 1")

    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.engine.app import Renderer
    from sailor_tpu_torch.scenes import content_instances_scene, flagship_scene

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.small:
        width, height, num_lights, num_objects = 640, 384, 128, 24
    else:
        width, height, num_lights, num_objects = 1920, 1088, 1000, 96
    if args.content:
        scene = content_instances_scene(width, height, num_lights, CONTENT_INSTANCES,
                                        args.content, device=device)
        what = f"{CONTENT_INSTANCES} instances of {os.path.basename(args.content)}"
    else:
        scene = flagship_scene(width, height, num_lights, num_objects, device=device)
        what = f"{num_objects} objects"
    print(f"# {scene.geometry.indices.shape[0]} tris ({what}), {num_lights} lights, "
          f"{width}x{height}, device={device}", file=sys.stderr)
    renderer = Renderer(RENDERER, width, height, config=CONFIG, device=device)

    def frame():
        targets = renderer.push_frame(scene)
        renderer.wait_idle()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return targets

    t0 = time.perf_counter()
    frame()
    print(f"# first frame: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        frame()
        times.append(time.perf_counter() - t0)
    print(f"== frames: best {min(times) * 1e3:.1f} ms ({1.0 / min(times):.2f} FPS), "
          f"times {[round(t * 1e3, 1) for t in times]}")

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.trace, exist_ok=True)
        with profile(activities=activities) as prof:
            frame()
        path = os.path.join(args.trace, "frame.json")
        prof.export_chrome_trace(path)
        print(f"# trace written to {path}", file=sys.stderr)

    timings = renderer.profile_nodes(repeats=args.frames)
    total = sum(timings.values())
    print(f"\n== per-node (synchronised, best of {args.frames}) ==")
    for k, v in sorted(timings.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<24} {v:8.2f} ms  {100 * v / total:5.1f}%")
    print(f"  {'TOTAL':<24} {total:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
