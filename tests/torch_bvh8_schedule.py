"""The BVH8 kernel's schedule, modelled on the CPU: the bounce-1 pass and
its shadow pass of both BVH8 cells (the bench tracer scene with 4 pooled
samples, and the dense scene with one), recorded at a cut size, walked by
the twin, then run through ``chip_smoke.bvh8_schedule`` as the
one-thread-a-ray mapping (a warp each 32 rays, no refill, both branches)
and as the persistent kernel at several refill thresholds and leaf waits.
Not a test (it is not collected): the model behind the prediction in
PERF.md. Counts only, no times.

    python tests/torch_bvh8_schedule.py [SIZE] [WARPS]

SIZE (default 128) is the square image; WARPS (default 132) the warps the
persistent grid holds: at 128x128, 132 warps keep the rays a warp of 2,112
warps at 512x512 (528 blocks of 4; ``bvh8.kernel_info()`` gives the card's
resident blocks: 660 for the kernel as built, so 165 at 128x128).
``sweep.SMEM_BUDGET`` is set to 0 so every pass takes the BVH8 route, as
the cells do at 512x512. About 15 s on one core at 128x128.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sailor_tpu_torch.raytracing import bvh8, sweep  # noqa: E402
from sailor_tpu_torch.scenes import dense_tracer_scene, tracer_scene  # noqa: E402

SCHEDULES = [(32, 0), (32, 1000), (1, 0), (8, 0), (16, 0), (24, 0), (16, 2), (16, 4),
             (16, 8), (16, 1000), (8, 4), (24, 4)]


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    warps = int(sys.argv[2]) if len(sys.argv) > 2 else 132
    torch.set_num_threads(1)
    sweep.SMEM_BUDGET = 0
    cells = (("tracer-batch4", lambda: tracer_scene("cpu"), 4),
             ("tracer-dense", lambda: dense_tracer_scene("cpu"), 1))
    for label, make, sb in cells:
        scene, cam, view, proj = make()
        passes = chip_smoke.record_passes(scene, cam, view, proj, size, size,
                                          sample_batch=sb)
        for name, p in (("bounce1", passes[2]), ("bounce1_shadow", passes[3])):
            args = bvh8.ray_inputs(p["origin"], p["direction"], None, p["active"])
            *_, work, walks = chip_smoke.bvh8_walks(scene.bvh.table, args, p["any_hit"])
            n = args[0].shape[0]
            old = (work["lane_steps"] / (32 * max(1, work["warp_steps"])),
                   work["lane_steps"] / (32 * max(1, work["warp_branch_steps"])))
            print(f"{label}/{name} {size}x{size}: rays={n} active={int(args[3].sum())} "
                  f"lane_steps={work['lane_steps']} one-thread-a-ray: warp_steps="
                  f"{work['warp_steps']} branch_steps={work['warp_branch_steps']} "
                  f"lane_use={old[0]:.3f} branch_use={old[1]:.3f}", flush=True)
            for refill, wait in SCHEDULES:
                m = chip_smoke.bvh8_schedule(walks, args[3].cpu().numpy(), warps, refill, wait)
                assert (m["rows"] == walks[1]).all()
                print(f"  persistent refill_idle={refill} leaf_wait={wait}: "
                      f"warp_steps={m['warp_steps']} branch_steps={m['warp_branch_steps']} "
                      f"lane_use={m['lane_steps'] / (32 * m['warp_steps']):.3f} "
                      f"branch_use={m['lane_steps'] / (32 * m['warp_branch_steps']):.3f} "
                      f"longest_warp={m['longest_warp']} branch steps against one-thread-"
                      f"a-ray's {work['warp_branch_steps'] / m['warp_branch_steps']:.2f}x "
                      f"fewer", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
