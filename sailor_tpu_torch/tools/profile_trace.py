"""Phase ablation of the path tracer's cost per sample on the bench tracer
scene (counterpart of the JAX package's tools/profile_trace.py).

Each phase is timed with CUDA events after a synchronise (the least of 3
runs after a warm-up):
  - closest-hit intersect alone (B4's tables + B5), coherent and incoherent
    rays;
  - any-hit intersect alone;
  - the prologue before the sweep kernel alone (``sweep.prepare``: the
    padding and B4, which writes the feature rows and visit tables);
  - one full sample pass (``path_tracer._trace_one_sample``, ``--bounces``);
  - shade only (``path_tracer._shade_hit`` on a fixed intersect result).

Usage:
  python -m sailor_tpu_torch.tools.profile_trace             # the card, 512 x 512
  python -m sailor_tpu_torch.tools.profile_trace --small     # 256 x 256
  python -m sailor_tpu_torch.tools.profile_trace --cpu       # the twins, 32 x 32
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true", help="256 x 256 instead of 512 x 512")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain twins on the CPU (32 x 32, a small scene)")
    ap.add_argument("--bounces", type=int, default=4)
    args = ap.parse_args(argv)

    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.raytracing import path_tracer as pt
    from sailor_tpu_torch.raytracing import sweep as sweep_mod
    from sailor_tpu_torch.tools import best_ms, tracer_setup

    device = resolve_device("cpu" if args.cpu else "cuda")
    size = 32 if args.cpu else 256 if args.small else 512
    scene, o, d = tracer_setup(device, size, small_scene=args.cpu)
    r = o.shape[0]
    print(f"# {scene.num_triangles} tris, {scene.sweep.n_clusters} clusters, "
          f"{size}x{size}, device={device}", file=sys.stderr)
    g = torch.Generator(device=device).manual_seed(3)
    db = torch.randn((r, 3), generator=g, device=device)
    db = db / db.norm(dim=1, keepdim=True)
    ob = o + d * 5.0  # incoherent, bounce-like rays from points along the view rays

    def line(name, ms, rays=None):
        rate = f"  ({rays / (ms * 1e-3) / 1e6:6.1f} Mrays/s)" if rays else ""
        print(f"{name:<20}{ms:9.3f} ms{rate}")

    sw = scene.sweep
    line("closest coherent:", best_ms(lambda: sweep_mod.intersect(sw, o, d), device), r)
    line("closest incoherent:", best_ms(lambda: sweep_mod.intersect(sw, ob, db), device), r)
    line("any-hit coherent:",
         best_ms(lambda: sweep_mod.intersect(sw, o, d, any_hit=True), device), r)
    line("prologue alone:", best_ms(lambda: sweep_mod.prepare(sw, o, d), device))
    u = torch.rand((5 * args.bounces, r), generator=g, device=device)
    rays0 = torch.zeros((), device=device)
    line("one sample pass:", best_ms(
        lambda: pt._trace_one_sample(scene, o, d, u, args.bounces, rays0), device))
    print(f"{'':<20}({args.bounces} bounces)")
    res = sweep_mod.intersect(sw, o, d)
    line("shade_hit alone:", best_ms(lambda: pt._shade_hit(scene, res, o, d), device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
