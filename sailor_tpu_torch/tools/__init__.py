"""Command-line diagnostics of the port (counterparts of the JAX package's
tools/time_sweep.py and tools/profile_trace.py), run as
``python -m sailor_tpu_torch.tools.<name>``: on the card by default, on
the CPU's plain twins with ``--cpu``."""

from __future__ import annotations

import time

import torch


def best_ms(fn, device: torch.device, reps: int = 3) -> float:
    """The least of ``reps`` timed calls of ``fn`` after one untimed call,
    in milliseconds: each after a synchronise and timed with CUDA events
    on the card, with the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def tracer_setup(device: str, size: int, small_scene: bool):
    """The bench tracer scene (``scenes.tracer_scene``; with
    ``small_scene`` 2 spheres of 6 x 12, for a CPU run a test can afford)
    and its unjittered primary rays at ``size`` x ``size``."""
    from sailor_tpu_torch import scenes
    from sailor_tpu_torch.raytracing import path_tracer as pt

    kw = dict(rings=6, sectors=12, spheres=2) if small_scene else {}
    scene, cam, view, proj = scenes.tracer_scene(device, tracer="sweep", **kw)
    o, d = pt.camera_rays(cam, view, proj, size, size, 0.5, 0.5)
    return scene, o, d
