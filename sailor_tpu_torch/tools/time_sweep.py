"""Marginal time of one sweep intersect (B4's tables + B5, or B6 with
``SAILOR_SWEEP_DMA=0``) on the bench tracer scene (counterpart of the JAX
package's tools/time_sweep.py).

Chains K dependent ``sweep.intersect`` calls, each re-aiming the rays
from the previous hits so that nothing can be skipped, times the chain of
1 and of K with CUDA events after a synchronise, and prints
(T(K) - T(1)) / (K - 1), the cost of one dispatch free of the chain's
fixed costs. The sweep's own knobs (``SAILOR_SWEEP_*``: the cluster size
``SAILOR_SWEEP_CLUSTER``; the rays of a ray block ``SAILOR_SWEEP_RAY_BLOCK``
(2048) and of a sub-block ``SAILOR_SWEEP_SUB`` (256), which must divide it;
``SAILOR_SWEEP_DMA``, ``SAILOR_SWEEP_SMEM``) apply as
``raytracing/sweep.py`` reads them; the scene's sweep is built at the
default cluster size, which the tool prints with the ray block and
sub-block beside its result.

Usage:
  python -m sailor_tpu_torch.tools.time_sweep              # the card, 512 x 512
  SAILOR_SWEEP_CLUSTER=512 python -m sailor_tpu_torch.tools.time_sweep
  SAILOR_SWEEP_RAY_BLOCK=4096 SAILOR_SWEEP_SUB=512 python -m sailor_tpu_torch.tools.time_sweep
  python -m sailor_tpu_torch.tools.time_sweep --cpu        # the twins, 32 x 32
  python -m sailor_tpu_torch.tools.time_sweep --size 256 --k 5 --any-hit --incoherent
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run the plain twins on the CPU")
    ap.add_argument("--size", type=int, default=None,
                    help="rays a side (default 512 on the card, 32 with --cpu)")
    ap.add_argument("--k", type=int, default=9, help="dispatches in the long chain")
    ap.add_argument("--any-hit", action="store_true", help="any-hit (shadow) queries")
    ap.add_argument("--incoherent", action="store_true", help="random ray directions")
    args = ap.parse_args(argv)

    from sailor_tpu_torch.config import resolve_device
    from sailor_tpu_torch.raytracing import sweep as sweep_mod
    from sailor_tpu_torch.tools import best_ms, tracer_setup

    device = resolve_device("cpu" if args.cpu else "cuda")
    size = args.size or (32 if args.cpu else 512)
    if args.k < 2:
        ap.error("--k must be at least 2")
    scene, o, d = tracer_setup(device, size, small_scene=args.cpu)
    sw = scene.sweep
    r = o.shape[0]
    if args.incoherent:
        g = torch.Generator(device=device).manual_seed(3)
        d = torch.randn((r, 3), generator=g, device=device)
        d = d / d.norm(dim=1, keepdim=True)
        o = o + 5.0
    print(f"# {scene.num_triangles} tris, {sw.n_clusters} clusters of {sw.cluster}, "
          f"RAY_BLOCK={sweep_mod.RAY_BLOCK} SUB={sweep_mod.SUB} DMA={sweep_mod.DMA_SWEEP} "
          f"size={size} any_hit={args.any_hit} incoherent={args.incoherent} device={device}",
          file=sys.stderr)

    def chain(k):
        o_ = o
        acc = torch.zeros((), device=device)
        for _ in range(k):
            res = sweep_mod.intersect(sw, o_, d, any_hit=args.any_hit)
            t = torch.where(torch.isfinite(res["t"]), res["t"], 0.0)
            o_ = o_ + 1e-7 * t[:, None]  # re-aim from the hits: a dependency chain
            acc = acc + t.sum()
        return acc

    t1 = best_ms(lambda: chain(1), device)
    tk = best_ms(lambda: chain(args.k), device)
    per = (tk - t1) / (args.k - 1)
    rate = r / (per * 1e-3) / 1e6 if per > 0 else float("inf")
    print(f"T(1)={t1:.3f} ms  T({args.k})={tk:.3f} ms  per-dispatch={per:.3f} ms  "
          f"({rate:.1f} Mrays/s)  cluster={sw.cluster} ray_block={sweep_mod.RAY_BLOCK} "
          f"sub={sweep_mod.SUB}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
