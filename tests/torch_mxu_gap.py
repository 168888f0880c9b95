"""B7's two plane forms (VPU and MXU) at the flagship frame's size, in the
JAX package (Pallas in interpret mode) and in the PyTorch port (plain
twins), on the CPU: both packages raster the port's frame setup
(``triangle_setup(zplane_rounding="frame")``, bin_sorted, windows of 256,
kmax 16). Prints, per form, whether the port's depth and ids equal the
reference's, and per package the MXU form's gap to the VPU form's: the
largest depth difference and the pixels whose winner changes where the
depths differ. Not a test (it is not collected): a measurement.

    python tests/torch_mxu_gap.py [width height lights objects]

Defaults to the flagship frame (1920 1088 1000 96): ~1 minute, < 1 GiB.
"""

import os
import sys
import time

os.environ.setdefault("SAILOR_AOT_CACHE", "0")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from sailor_tpu.raster import setup as j_setup  # noqa: E402
from sailor_tpu.raster import tile_raster as j_tr  # noqa: E402
from sailor_tpu_torch.raster import setup as t_setup  # noqa: E402
from sailor_tpu_torch.raster import tile_raster as t_tr  # noqa: E402
from sailor_tpu_torch.scenes import flagship_scene  # noqa: E402


def main(width=1920, height=1088, lights=1000, objects=96):
    tx, ty = -(-width // t_tr.TILE_W), -(-height // t_tr.TILE_H)
    ts = flagship_scene(width, height, lights, objects, device="cpu")
    tri, aabb = t_setup.triangle_setup(ts.geometry, ts.frame.view_projection, width=width,
                                       height=height, cull="back", zplane_rounding="frame")
    rb = t_setup.bin_sorted(tri.valid, aabb, tiles_x=tx, tiles_y=ty, tile_w=t_tr.TILE_W,
                            tile_h=t_tr.TILE_H)
    jtri = j_setup.TriangleSetup(**{f: jnp.asarray(getattr(tri, f).numpy()) for f in
                                    ("edge", "zplane", "valid", "src_id", "zmax")})
    jaabb = tuple(jnp.asarray(a.numpy()) for a in aabb)
    jrb = [jnp.asarray(x.numpy()) for x in rb]
    kw = dict(tiles_y=ty, tiles_x=tx, chunk=256, kmax=16)
    res = {}
    for mxu in (False, True):
        t0 = time.time()
        d, t, _ = j_tr.rasterize_stream(jtri, jaabb, *jrb[:5], mxu=mxu, **kw)
        res["reference", mxu] = (np.asarray(d), np.asarray(t))
        t1 = time.time()
        d, t, _ = t_tr.rasterize_stream(tri, aabb, *rb[:5], mxu=mxu, **kw)
        res["port", mxu] = (d.numpy(), t.numpy())
        (dr, ir), (dp, ip) = res["reference", mxu], res["port", mxu]
        print(f"mxu={mxu}: port vs reference depth_equal={np.array_equal(dr, dp)} "
              f"tid_equal={np.array_equal(ir, ip)} (reference {t1 - t0:.1f} s, "
              f"port {time.time() - t1:.1f} s)")
    for who in ("reference", "port"):
        (dv, iv), (dm, im) = res[who, False], res[who, True]
        print(f"{who} {width}x{height} MXU vs VPU: max_depth_diff={np.abs(dm - dv).max():.6g} "
              f"depth_px_differ={int((dm != dv).sum())} tid_mismatch={int((im != iv).sum())} "
              f"tid_mismatch_untied={int(((im != iv) & (dm != dv)).sum())}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:5]))
