"""The traced run's instruments, all on the harness side: spans
(``torch.profiler.record_function``) around the calls into the program,
a wrapper around a frame-graph node type or a module function, the
synchronising-call counter, and the reading of the profiler's events
into device intervals, kernel time by name and idle gaps by span."""

from __future__ import annotations

import contextlib
import dataclasses

from benchmark.harness import window

SPAN_PREFIX = "bench:"
PORT_MARK = "(anonymous namespace)::"  # the port's csrc kernels; PyTorch's are at::native


@dataclasses.dataclass
class Trace:
    """What one traced window left: device kernels and harness spans as
    (name, start s, end s) on one clock, the window, the units (frames or
    renders) traced, and counters the driver read beside the trace."""

    kernels: list
    spans: list
    start: float
    end: float
    units: int
    counters: dict

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return window.union_length([(a, b) for _, a, b in self.kernels])

    def device_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.kernels if match(n))

    def is_port(self, name: str) -> bool:
        return PORT_MARK in name and "at::native" not in name

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, a, b in self.kernels:
            by[n] = by.get(n, 0.0) + (b - a)
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time inside the window, summed by the innermost
        harness span the host was in at each gap's middle."""
        by = {}
        spans = [(n, a, b) for n, a, b in self.spans]
        for a, b in window.gaps([(x, y) for _, x, y in self.kernels], self.start, self.end):
            name = window.innermost(spans, (a + b) / 2) or "outside any span"
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def span(name: str):
    """A harness span (a no-op outside a profiler session)."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def profiled(fn):
    """Run fn() under torch.profiler (CPU and CUDA activity) and return
    (fn's result, kernels, spans, window start, window end), times in
    seconds on the profiler's clock; the window runs from the first
    harness span's start to the later of its last end and the last
    kernel's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels, spans = [], []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):  # a span's range on the GPU timeline
                kernels.append((e.name, a, b))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], a, b))
    if not spans:
        raise RuntimeError("the traced window recorded no harness span")
    start = min(a for _, a, _ in spans)
    end = max([b for _, _, b in spans] + [b for _, _, b in kernels])
    return out, kernels, spans, start, end


@contextlib.contextmanager
def sync_counter():
    """CUDA's sync debug mode on: yields a function that gives the
    synchronising calls made so far (each warns once)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield lambda: sum("synchroniz" in str(c.message) for c in caught)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def around_nodes(before=None, after=None, names=None):
    """Wraps ``process`` of each frame-graph node type (or those in
    ``names``): ``before(name, targets)`` and ``after(name, targets)`` run
    around each call, inside a harness span ``node:<name>``."""
    from sailor_tpu_torch.framegraph.graph import node_types

    saved = {}
    for name, cls in node_types().items():
        if names is not None and name not in names:
            continue
        if "process" not in cls.__dict__:
            continue
        inner = cls.__dict__["process"]
        saved[cls] = inner

        def process(self, ctx, targets, _inner=inner, _name=name):
            if before is not None:
                before(_name, targets, ctx)
            with span("node:" + _name):
                out = _inner(self, ctx, targets)
            if after is not None:
                after(_name, out, ctx)
            return out

        cls.process = process
    try:
        yield
    finally:
        for cls, inner in saved.items():
            cls.process = inner


@contextlib.contextmanager
def around_call(module, name, hook):
    """Wraps ``module.name``: ``hook(args, kwargs, result)`` sees each
    call."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        hook(args, kwargs, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, inner)
