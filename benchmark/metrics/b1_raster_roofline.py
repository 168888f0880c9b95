"""B1's share of its roofline over the traced frames: the least time
of its passes (benchmark/bounds/raster.py, from the scene's triangles)
over the device time of the raster's plan and run kernels, in %."""

import re

from benchmark.bounds import raster

B1 = re.compile(r"\b(plan_kernel|raster_runs_kernel)\b")


def read(trace, session):
    spent = trace.device_s(lambda n: trace.is_port(n) and B1.search(n) is not None)
    if spent <= 0:
        return None
    cfg = session.cell.config["settings"]
    bound = raster.frame_s(session.host, session.capture["masked_layers"],
                           int(cfg["transparent_layers"]), session.capture["depth"].device)
    return 100.0 * bound * trace.units / spent
