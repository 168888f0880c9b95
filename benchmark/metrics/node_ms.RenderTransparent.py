"""RenderTransparent's ms in a frame run node by node (a synchronise
after each node: overlap between nodes removed), from the traced run."""


def read(trace, session):
    return trace.counters.get("node_ms", {}).get("RenderTransparent")
