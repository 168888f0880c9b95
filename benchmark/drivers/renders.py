"""The render loop: one client calls the port's
``path_tracer.render_cached`` back to back on a fixed scene, each render
with a new sample seed drawn from ``--seed``.

The configuration's ``render`` block gives ``spp`` and ``bounces``. The
swizzle of the rays into pixel supertiles (the port's ray block and
sub-block, which the reference needs to find a slot's pixel) is read
from the port at run time (``swizzle``). Traffic
parameters: ``max_in_flight`` (renders queued on the device before the
host waits for the oldest), ``sample_batch``, ``bounce_sort``,
``warmup_renders``,
``traced_renders``, ``judge_among``, ``judged_slots`` (pixels the
reference traces) and ``judged_rays`` (rows sampled from each
intersector pass).

End-to-end metric: ``mrays_per_s``, the rays of every render completed
in the window (live rays plus facing shadow rays, as ``render_cached``
counts them) over the window's start to the last completion, on CUDA
events.
"""

from __future__ import annotations

import dataclasses
import random
import time

from benchmark.harness import clock, tracing, window

MAX_RENDERS = 100000


@dataclasses.dataclass
class Session:
    cell: object
    host: dict
    program: tuple
    device: object
    seeds: list
    judged: int
    capture: dict = dataclasses.field(default_factory=dict)
    bad: object = None
    counters: dict = dataclasses.field(default_factory=dict)


def setup(cell, seed: int, device) -> Session:
    import torch

    args = cell.config["scene_args"]
    scene_mod = cell.scene()
    host = scene_mod.host(args, seed)
    tr = cell.traffic
    warm = int(tr["warmup_renders"])
    seeds = scene_mod.render_seeds(seed, MAX_RENDERS + warm)
    s = Session(cell=cell, host=host, program=scene_mod.program(host, device),
                device=torch.device(device), seeds=seeds,
                judged=random.Random(seed).randrange(int(tr["judge_among"])))
    for i in range(warm):
        _render(s, seeds[MAX_RENDERS + i])
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    return s


def _render(s, seed):
    from sailor_tpu_torch.raytracing import path_tracer

    tr, rc = s.cell.traffic, s.cell.config["render"]
    scene, cam, view, proj = s.program
    return path_tracer.render_cached(
        scene, cam, view, proj, width=s.host["width"], height=s.host["height"],
        spp=int(rc["spp"]), max_bounces=int(rc["bounces"]), seed=seed,
        sample_batch=int(tr["sample_batch"]), sort_bounces=bool(tr["bounce_sort"]))


def swizzle() -> dict:
    """The port's ray block and sub-block as it runs them (its
    ``SAILOR_SWEEP_RAY_BLOCK`` and ``SAILOR_SWEEP_SUB`` can change them)."""
    from sailor_tpu_torch.raytracing import sweep

    return {"ray_block": int(sweep.RAY_BLOCK), "sub": int(sweep.SUB)}


class _Capture:
    """Keeps, for the judged render: every sort key of its wavefront,
    sampled rows of each intersector pass of its first pass, and its
    image at the judged slots (gathers on the device, no synchronise)."""

    def __init__(self, s):
        import torch

        self.s, self.on = s, False
        tr, rc = s.cell.traffic, s.cell.config["render"]
        self.bounces = int(rc["bounces"])
        h = s.host
        from benchmark.reference import tracer as ref

        self.swizzle = swizzle()
        perm, owner, self.nslot = ref.swizzle(h["height"], h["width"],
                                              self.swizzle["ray_block"], self.swizzle["sub"])
        g = torch.Generator().manual_seed(s.seeds[0] & 0x7FFFFFFF)
        real = torch.nonzero(torch.from_numpy(owner))[:, 0]
        pick = real[torch.randperm(real.numel(), generator=g)[:int(tr["judged_slots"])]]
        self.slots = pick.to(s.device)
        self.pixels = torch.from_numpy(perm).to(s.device)[self.slots]
        n_rays = int(tr["sample_batch"]) * self.nslot
        self.rows = torch.randperm(n_rays, generator=g)[:int(tr["judged_rays"])].to(s.device)
        self.calls = self.per_pass = 0

    def isect(self, args, kwargs, out):
        if not self.on:
            return
        self.calls += 1
        if self.calls > 2 * self.bounces:
            return
        _, origin, direction = args[:3]
        active = kwargs.get("active")
        r = self.rows
        self.s.capture["passes"].append({
            "origin": origin[r], "direction": direction[r],
            "active": (active[r] if active is not None
                       else r.new_ones(r.shape, dtype=bool)),
            "any_hit": bool(kwargs.get("any_hit", False)),
            "t": out["t"][r], "hit": out["hit"][r], "tri": out["tri"][r]})

    def key(self, args, kwargs, out):
        if self.on:
            keys = self.s.capture["keys"]
            if self.per_pass == 0:
                keys.append([])
            keys[-1].append(out)
            self.per_pass = (self.per_pass + 1) % (self.bounces - 1)


def _loop(s, seconds=None, count=None):
    import torch

    from sailor_tpu_torch.raytracing import path_tracer

    cap = _Capture(s)
    tr, rc = s.cell.traffic, s.cell.config["render"]
    start = clock.mark(s.device)
    done, queued = [], []
    rays = torch.zeros((), dtype=torch.float64, device=s.device)
    max_q = int(tr["max_in_flight"])
    s.bad = torch.zeros((), dtype=torch.int64, device=s.device)
    with tracing.around_call(path_tracer, "_isect", cap.isect), \
            tracing.around_call(path_tracer, "_bounce_sort_key", cap.key):
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        t_end = time.perf_counter() + (seconds or 0)
        start.record()
        with tracing.span("window"):
            i = 0
            # the window holds the judged unit, however short it is
            while (count is not None and i < count) or (count is None and (
                    time.perf_counter() < t_end or i <= s.judged)):
                if len(queued) >= max_q:
                    queued.pop(0).synchronize()
                cap.on = i == s.judged
                if cap.on:
                    s.capture.update(passes=[], keys=[], render=dict(
                        rc, seed=s.seeds[i], sample_batch=tr["sample_batch"], **cap.swizzle))
                    cap.calls = cap.per_pass = 0
                with tracing.span("render"):
                    img, n = _render(s, s.seeds[i])
                rays += n
                s.bad += (~torch.isfinite(img)).any()
                if cap.on:
                    s.capture["image_slots"] = img.reshape(-1, 3)[cap.pixels]
                    s.capture["slots"] = cap.slots
                    s.capture["key_pairs"] = (int(tr["judged_slots"]) * int(rc["spp"])
                                              * (int(rc["bounces"]) - 1))
                    cap.on = False
                ev = clock.mark(s.device, record=True)
                queued.append(ev)
                done.append(ev)
                i += 1
        with tracing.span("wait"):
            if s.device.type == "cuda":
                torch.cuda.synchronize(s.device)
    comp = [start.elapsed_time(e) for e in done]
    return len(done), comp, float(rays)


def window_run(s, seconds: float) -> dict:
    n, comp, rays = _loop(s, seconds=seconds)
    return {"attempted": n, "failed": int(s.bad),
            "metrics": {"mrays_per_s": window.rate(rays / 1e6, comp[-1] / 1e3)}}


def traced_run(s, seconds: float):
    n = int(s.cell.traffic["traced_renders"])
    s.judged = min(s.judged, n - 1)
    (renders, _, _), kernels, spans, a, b = tracing.profiled(lambda: _loop(s, count=n))
    return (tracing.Trace(kernels=kernels, spans=spans, start=a, end=b, units=renders,
                          counters=s.counters),
            {"attempted": renders, "failed": int(s.bad)})


def release(s):
    s.program = None
