"""Completion marks: CUDA events on the card (read after a synchronise,
on the device's clock), the host clock elsewhere (the CPU tests)."""

from __future__ import annotations

import time


class _HostMark:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def mark(device, record: bool = False):
    """A mark on ``device``'s stream; ``record`` records it now."""
    import torch

    m = (torch.cuda.Event(enable_timing=True) if torch.device(device).type == "cuda"
         else _HostMark())
    if record:
        m.record()
    return m
