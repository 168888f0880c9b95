"""Profiling (counterpart of sailor_tpu/utils/profiler.py; the Tracy macros
of Runtime/Core/Defines.h SAILOR_PROFILE_*): named zones timed on the
host clock, with an optional device synchronise, gathered per frame; and a
``torch.profiler`` trace for deep dives.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_zones: dict[str, list[float]] = defaultdict(list)
_enabled = True


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def profile_scope(name: str, sync: bool = False):
    """SAILOR_PROFILE_SCOPE: time a block. ``sync=True`` synchronises the
    card before the zone closes, so the zone holds the device work the
    block queued. A failed synchronise raises."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _zones[name].append((time.perf_counter() - t0) * 1e3)


def profile_function(fn):
    """SAILOR_PROFILE_FUNCTION decorator."""

    def wrapper(*a, **kw):
        with profile_scope(fn.__qualname__):
            return fn(*a, **kw)

    return wrapper


def end_frame() -> dict[str, tuple[int, float, float]]:
    """This frame's zones, name -> (count, total_ms, max_ms), and a new
    frame (Tracy's end-of-frame marker)."""
    out = {k: (len(v), sum(v), max(v)) for k, v in _zones.items() if v}
    _zones.clear()
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (host activity, and the
    card's kernels when CUDA is initialised) and write a Chrome trace,
    ``trace.json``, into ``log_dir``; the profiler object is yielded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
