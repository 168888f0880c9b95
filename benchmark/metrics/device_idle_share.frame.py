"""Share of the traced window in which no kernel ran on the device
(1 minus the union of kernel intervals over the window)."""


def read(trace, session):
    return 1.0 - trace.busy_s / trace.window_s
