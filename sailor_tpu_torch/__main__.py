"""Headless engine entry point (counterpart of sailor_tpu/__main__.py and
the reference's Exec/Main.cpp): load a world through the asset registry,
run the engine loop over a renderer file, run console commands, and write
the last frame.

  python -m sailor_tpu_torch --world content/Editor.world --frames 60 \\
      --out out.png [--width 1280 --height 704] [--cpu]

It runs on the CUDA device; ``--cpu`` runs the plain PyTorch path instead.
Without ``--cpu`` and without a card it raises. Content paths are relative
to the working directory, whose ``content/`` the registry scans.
"""

from __future__ import annotations

import argparse
import sys
import time

#: the Renderer config and the sun of the reference's CLI (sailor_tpu/__main__.py:50-54)
CLI_CONFIG = {"shadow_resolution": 512, "env_resolution": 32, "bin_capacity": 512,
              "bin_rounds": 2}
SUN_DIRECTION = (-0.35, -0.7, -0.3)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sailor_tpu_torch")
    ap.add_argument("--world", default="content/Editor.world")
    ap.add_argument("--renderer", default="content/DefaultRenderer.renderer")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain PyTorch path)")
    ap.add_argument("--command", action="append", default=[],
                    help="console command(s) to run after the loop")
    args = ap.parse_args(argv)

    import numpy as np

    from sailor_tpu_torch.assets.registry import AssetRegistry
    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.engine import World
    from sailor_tpu_torch.engine.app import EngineLoop, Renderer
    from sailor_tpu_torch.engine.console import Console
    from sailor_tpu_torch.kernels.sky import SkyParams
    from sailor_tpu_torch.utils.log import SAILOR_LOG
    from sailor_tpu_torch.utils.png import encode_png

    device = resolve_device("cpu" if args.cpu else None)
    registry = AssetRegistry()
    registry.scan_content_folder()
    world = World.load(args.world, assets=registry, device=device)
    renderer = Renderer(args.renderer, args.width, args.height, config=dict(CLI_CONFIG),
                        device=device)
    sky = SkyParams.default(sun_direction=SUN_DIRECTION)
    loop = EngineLoop(world, renderer, sky=sky)
    console = Console(world=world, renderer=renderer, assets=registry)

    SAILOR_LOG("sailor_tpu_torch: world '%s' %dx%d", world.name, args.width, args.height)
    t0 = time.time()
    targets = loop.run(args.frames)
    dt = time.time() - t0
    print(f"{args.frames} frames in {dt:.2f}s ({args.frames / dt:.2f} FPS incl. first-frame setup)")

    for cmd in args.command:
        print(f"> {cmd}")
        print(console.execute(cmd))

    if args.out and targets is not None:
        final = targets["Final"].detach().cpu().numpy()
        with open(args.out, "wb") as f:
            f.write(encode_png(np.asarray(final * 255).astype(np.uint8)))
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
