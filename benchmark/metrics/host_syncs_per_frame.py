"""Synchronising calls the host makes in one frame (CUDA's sync debug
mode, after the traced window)."""


def read(trace, session):
    return trace.counters.get("host_syncs_per_frame")
