"""Whether a render of the tracer scene is correct.

The render judged is one the window traced (its index drawn from the
seed); the driver keeps its image, the sort keys its wavefront was
ordered by, and sampled rows of each intersector pass of its first pass.

- ``isect_t_off``: share of the sampled live rays of the closest-hit
  passes where the program's hit and the brute-force reference's
  disagree, their t differ by more than 1e-4 of it (+1e-5), or the
  program's triangle differs from the reference's and the ray does not
  meet it (within 1e-4 of its edges) at the reference's t (two
  triangles that share the hit point are both right).
- ``isect_any_off``: the same of the any-hit (shadow) passes' hit flags.
- ``image_px_off``: share of sampled pixels whose value differs from the
  reference's path tracing of the same slots, with the same uniforms
  read at the same wavefront positions, by more than 1e-3 of it (+1e-3).
- ``sort_key_off``: share of (ray, sort) pairs where the reference's own
  key of its ray differs from the program's at that slot.

The reference reorders its rays by the program's keys (the program's
state), so ``sort_key_off`` checks that stage by itself. ``control`` puts
the reference computed in bfloat16 in the program's place.
"""

from __future__ import annotations

import torch

from benchmark.reference import tracer

# each limit between the sound runs' largest reading over 12 seeds and the
# bfloat16 control's smallest over 3, on the card at the cell's size
# (PERF.md, section 4)
LIMITS = {
    "isect_t_off": 2e-3,     # sound 0, control 0.587
    "isect_any_off": 2e-3,   # sound 0, control 0.103
    "image_px_off": 2e-2,    # sound 1.47e-3, control 0.975
    "sort_key_off": 3e-3,    # sound 1.22e-4, control 0.398
}


def _isect_numbers(passes, tri, dtype):
    off_t = n_t = off_a = n_a = 0
    for p in passes:
        act = p["active"]
        ref = tracer.intersect(tri, p["origin"].to(dtype), p["direction"].to(dtype),
                               any_hit=p["any_hit"])
        hp, hr = p["hit"] & act, ref["hit"] & act
        if p["any_hit"]:
            off_a += int((hp != hr).sum())
            n_a += int(act.sum())
        else:
            tp, tr = p["t"].float(), ref["t"].float()
            far = (tp - tr).abs() > 1e-4 * tr.abs() + 1e-5
            other = hp & hr & (p["tri"] != ref["tri"])
            t_o, u_o, v_o = tracer.hit_on(tri, p["tri"], p["origin"].to(dtype),
                                          p["direction"].to(dtype))
            meets = ((u_o >= -1e-4) & (v_o >= -1e-4) & (u_o + v_o <= 1 + 1e-4)
                     & ((t_o.float() - tr).abs() <= 1e-4 * tr.abs() + 1e-5))
            off_t += int(((hp != hr) | (hp & hr & far) | (other & ~meets)).sum())
            n_t += int(act.sum())
    return off_t / max(n_t, 1), off_a / max(n_a, 1)


def _image_off(got, ref):
    g, r = got.float(), ref.float()
    return float((((g - r).abs() > 1e-3 * r.abs() + 1e-3).any(-1)).float().mean())


def judge(cap, h, device, settings) -> dict:
    tri = tracer.triangles(h, torch.float32, device)
    t_off, a_off = _isect_numbers(cap["passes"], tri, torch.float32)
    ref, key_off = tracer.trace_slots(h, cap["render"], cap["slots"], cap["keys"] or None,
                                      device=device, tri=tri)
    return {"isect_t_off": t_off, "isect_any_off": a_off,
            "image_px_off": _image_off(cap["image_slots"], ref),
            "sort_key_off": key_off / max(cap["key_pairs"], 1)}


def control(cap, h, device, settings, dtype=torch.bfloat16) -> dict:
    tri = tracer.triangles(h, torch.float32, device)
    low_tri = tracer.triangles(h, dtype, device)
    passes = []
    for p in cap["passes"]:
        low = tracer.intersect(low_tri, p["origin"].to(dtype), p["direction"].to(dtype),
                               any_hit=p["any_hit"])
        passes.append(dict(p, t=low["t"], hit=low["hit"], tri=low["tri"]))
    t_off, a_off = _isect_numbers(passes, tri, torch.float32)
    keys = cap["keys"] or None
    ref, _ = tracer.trace_slots(h, cap["render"], cap["slots"], keys, device=device, tri=tri)
    low, key_off = tracer.trace_slots(h, cap["render"], cap["slots"], keys, dtype=dtype,
                                      device=device, tri=low_tri)
    return {"isect_t_off": t_off, "isect_any_off": a_off, "image_px_off": _image_off(low, ref),
            "sort_key_off": key_off / max(cap["key_pairs"], 1)}
