"""B3's share of its roofline over the traced frames: the least time of
the shade (benchmark/bounds/shade.py) on the judged frame's light lists,
recomputed by the reference culling from its Depth, over the device time
of the shade kernel, in %."""

import re

import numpy as np
import torch

from benchmark.bounds import shade
from benchmark.reference import light_cull

B3 = re.compile(r"\bshade_kernel\b")


def read(trace, session):
    spent = trace.device_s(lambda n: trace.is_port(n) and B3.search(n) is not None)
    if spent <= 0:
        return None
    h, cap, cfg = session.host, session.capture, session.cell.config["settings"]
    dev = cap["depth"].device
    lights = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in h["lights"].items()}
    inv_proj = torch.from_numpy(np.linalg.inv(h["proj"].astype(np.float64)).astype(
        np.float32)).to(dev)
    idx, _ = light_cull.cull(
        lights, torch.from_numpy(h["view"]).to(dev), inv_proj,
        light_cull.linearize(cap["depth"], h["z_near"], h["z_far"]),
        tiles_y=h["height"] // 16, tiles_x=h["width"] // 16, viewport=(h["width"], h["height"]),
        max_per_tile=int(cfg["max_lights_per_tile"]),
        coarse_capacity=int(cfg["light_coarse_capacity"]))
    bound = shade.frame_s(idx, len(h["lights"]["type"]))
    return 100.0 * bound * trace.units / spent
