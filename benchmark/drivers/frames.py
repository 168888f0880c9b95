"""The frame loop: one client renders frames of a fixed scene back to
back, ``prepare`` then ``process`` of the port's ``FrameGraph`` each
frame, with at most ``max_in_flight`` frames queued on the device (the
host waits on the completion event of the frame that many back, as the
engine's ``Renderer.push_frame`` paces them).

Traffic parameters: ``max_in_flight``, ``warmup_frames``,
``traced_frames`` (the traced window), ``judge_among`` (the judged frame
is drawn from the window's first that many).

End-to-end metrics: ``frame_ms`` (window start to the device completion
of the last frame, over the frames) and ``frame_ms_p95`` (the 95th
percentile of the intervals between consecutive completions, the first
from the window's start), both from CUDA events.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

from benchmark.harness import clock, tracing, window


@dataclasses.dataclass
class Session:
    cell: object
    host: dict
    scene: object
    graph: object
    state: dict
    device: object
    judged: int
    capture: dict = dataclasses.field(default_factory=dict)
    bad: object = None
    counters: dict = dataclasses.field(default_factory=dict)


def setup(cell, seed: int, device) -> Session:
    import torch

    from sailor_tpu_torch.framegraph import FrameGraph, FrameGraphAsset

    args = cell.config["scene_args"]
    scene_mod = cell.scene()
    host = scene_mod.host(args, seed)
    scene = scene_mod.program(host, device)
    graph = FrameGraph(FrameGraphAsset.from_yaml(json.dumps(cell.config["graph"])),
                       host["width"], host["height"], dict(cell.config["settings"]),
                       device=device)
    s = Session(cell=cell, host=host, scene=scene, graph=graph,
                state=graph.initial_state(), device=torch.device(device),
                judged=random.Random(seed).randrange(int(cell.traffic["judge_among"])))
    for _ in range(int(cell.traffic["warmup_frames"])):
        _frame(s)
    _sync(s)
    return s


def _sync(s):
    import torch

    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)


def _frame(s):
    s.graph.prepare(s.scene, s.state)
    targets, s.state = s.graph.process(s.scene, s.state)
    return targets


class _Capture:
    """Keeps what the stages of one frame produced (references only: no
    copy, no synchronise)."""

    def __init__(self, s):
        self.s, self.on, self.node = s, False, None

    def before(self, name, targets, ctx):
        self.node = name
        if not self.on:
            return
        c = self.s.capture
        if name == "RenderTransparent":
            c["main_in_t"], c["t_layers"] = targets["Main"], []
        elif name == "EyeAdaptation":
            c["main_in_ea"], c["prev_avg"] = targets["Main"], ctx.state["avg_luminance"]
            c["dt"] = 1.0 / 60 + 0.25
            c["tau"] = float(ctx.value("EyeAdaptation.Tau", 1.1))

    def after(self, name, targets, ctx):
        self.node = None
        if not self.on:
            return
        c = self.s.capture
        if name == "DepthPrepass":
            c.update(depth=targets["Depth"], tid=targets["TriId"],
                     src=targets["TriSetup"].src_id,
                     masked_layers=int(targets.get("MaskedPeelLayers", 0)))
        elif name == "LightCulling":
            c["light_idx"] = targets["LightIndices"]
        elif name == "RenderTransparent":
            c["main_out_t"] = targets["Main"]
        elif name == "EyeAdaptation":
            c["final"] = targets["Final"]

    def shade_kernel(self, args, kwargs, out):
        if self.on:
            self.s.capture["b3"] = (args[0], args[2], kwargs.get("shadow_factors"),
                                    kwargs.get("ibl_ambient"))
            self.s.capture["b3_out"] = out

    def resolve(self, args, kwargs, out):
        if self.on and self.node == "RenderTransparent" and kwargs.get("return_extras"):
            self.s.capture["_opacity"] = out[3]["opacity"]

    def shade_plain(self, args, kwargs, out):
        if self.on and self.node == "RenderTransparent":
            self.s.capture["t_layers"].append((args[0], self.s.capture.pop("_opacity")))


def _instruments(cap):
    import contextlib

    from sailor_tpu_torch.kernels import pbr, pbr_kernel
    from sailor_tpu_torch.raster import interpolate

    stack = contextlib.ExitStack()
    stack.enter_context(tracing.around_nodes(cap.before, cap.after))
    stack.enter_context(tracing.around_call(pbr_kernel, "shade_forward_plus_kernel",
                                            cap.shade_kernel))
    stack.enter_context(tracing.around_call(interpolate, "resolve_gbuffer_stream", cap.resolve))
    stack.enter_context(tracing.around_call(pbr, "shade_forward_plus", cap.shade_plain))
    return stack


def _loop(s, seconds=None, count=None):
    """Frames back to back until ``seconds`` have passed on the host clock
    (or ``count`` frames): (frames, completion ms since the window's
    start)."""
    import torch

    cap = _Capture(s)
    max_q = int(s.cell.traffic["max_in_flight"])
    start = clock.mark(s.device)
    done, queued = [], []
    s.bad = torch.zeros((), dtype=torch.int64, device=s.device)
    with _instruments(cap):
        _sync(s)
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
                with tracing.span("frame"):
                    with tracing.span("prepare"):
                        s.graph.prepare(s.scene, s.state)
                    targets, s.state = s.graph.process(s.scene, s.state)
                    s.bad += (~torch.isfinite(targets["Final"])).any()
                ev = clock.mark(s.device, record=True)
                queued.append(ev)
                done.append(ev)
                i += 1
            cap.on = False
        with tracing.span("wait"):
            _sync(s)
    comp = [start.elapsed_time(e) for e in done]
    return len(done), comp


def window_run(s, seconds: float) -> dict:
    n, comp = _loop(s, seconds=seconds)
    return {"attempted": n, "failed": int(s.bad),
            "metrics": {"frame_ms": comp[-1] / n,
                        "frame_ms_p95": window.percentile(window.intervals(comp), 95)}}


def traced_run(s, seconds: float):
    """The traced window (``traced_frames`` frames under the profiler),
    then one frame node by node (a synchronise after each) and one frame
    under CUDA's sync debug mode, outside the trace."""
    n = int(s.cell.traffic["traced_frames"])
    s.judged = min(s.judged, n - 1)
    (frames, _), kernels, spans, a, b = tracing.profiled(lambda: _loop(s, count=n))
    tr = tracing.Trace(kernels=kernels, spans=spans, start=a, end=b, units=frames,
                       counters=s.counters)
    s.graph.prepare(s.scene, s.state)
    _, s.state, node_ms = s.graph.process_debug(s.scene, s.state)
    s.counters["node_ms"] = {k.split("_", 1)[1]: v for k, v in node_ms.items()}
    with tracing.sync_counter() as syncs:
        _frame(s)
        s.counters["host_syncs_per_frame"] = syncs()
    return tr, {"attempted": frames, "failed": int(s.bad)}


def release(s):
    """Drop the program's state; keep what the check reads."""
    s.graph = s.scene = s.state = None
