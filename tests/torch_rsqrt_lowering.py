"""How XLA:CPU lowers the reference's rsqrt (sailor_tpu/raster/setup.py,
the edge normalisation of ``triangle_setup``), and whether the port could
reproduce it. Not a test (it is not collected); runs on the CPU in about
a minute:

    python tests/torch_rsqrt_lowering.py

1. Compiles the reference's ``triangle_setup`` (the flagship scene at
   256x128) with XLA's dump on (into build/rsqrt_dump/, under the
   checkout) and reports the reciprocal square root intrinsics and the
   Newton-Raphson refinement in its optimised LLVM IR.
2. Runs ``jax.lax.rsqrt`` on 2^21 seeded inputs and counts the results
   that differ from the correctly rounded 1/sqrt(x), with the largest
   difference in units in the last place.
3. Applies the refinement the IR shows (y' = y + (-0.5 y)(x y y - 1),
   twice, the inner terms contracted to fused multiply-adds as XLA:CPU
   compiles them) to estimates of the same 12-bit accuracy that differ
   only in how they round, and counts how often each gives the reference's
   result. If that depends on the estimate, the port can only match the
   reference bit for bit by reproducing the estimate's table.
"""

import glob
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMP = os.path.join(ROOT, "build", "rsqrt_dump")
os.environ["XLA_FLAGS"] = f"--xla_dump_to={DUMP} --xla_dump_hlo_as_text"
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from sailor_tpu.raster import setup as j_setup  # noqa: E402
from test_torch_scenes import jax_scene  # noqa: E402


def lowering():
    js = jax_scene(256, 128, 4, 4)
    fn = jax.jit(lambda g, vp: j_setup.triangle_setup(g, vp, width=256, height=128,
                                                      cull="back"))
    jax.block_until_ready(fn(js.geometry, js.frame.view_projection))
    found = {}
    for path in glob.glob(os.path.join(DUMP, "*triangle_setup*ir-with-opt.ll")) + glob.glob(
            os.path.join(DUMP, "*lambda*ir-with-opt.ll")):
        text = open(path).read()
        for name in re.findall(r"@llvm\.x86\.[a-z0-9.]*rsqrt[a-z0-9.]*", text):
            found[name] = found.get(name, 0) + 1
        found["fmul by -0.5"] = found.get("fmul by -0.5", 0) + len(
            re.findall(r"fmul[^\n]*-5\.000000e-01", text))
    return found


def refine(x, y, f32=np.float32):
    """Two Newton-Raphson steps as the reference's IR has them, with the
    products x*y*y - 1 and (-0.5 y)*t + y fused."""
    for _ in range(2):
        h = y * f32(-0.5)
        t = ((x * y).astype(np.float64) * y - 1.0).astype(f32)
        y = (h.astype(np.float64) * t + y).astype(f32)
    return y


def main():
    print("triangle_setup's optimised IR:", lowering())
    rng = np.random.default_rng(0)
    x = rng.uniform(1e-3, 1e3, 1 << 21).astype(np.float32)
    got = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - exact.view(np.int32))
    print(f"jax.lax.rsqrt on {x.size} inputs: {np.mean(got != exact):.4f} differ from the "
          f"correctly rounded 1/sqrt, by at most {ulps.max()} ulp")
    r = 1.0 / np.sqrt(x.astype(np.float64))
    for rel in (0.0, 1e-4, -1e-4, 3e-4, -3e-4):
        est = (r * (1.0 + rel)).astype(np.float32)
        est = (est.view(np.int32) & ~0xFFF).view(np.float32)  # a 12-bit table value
        print(f"refined 12-bit estimate (relative offset {rel:+.0e}): equals jax.lax.rsqrt "
              f"on {np.mean(refine(x, est) == got):.4f} of inputs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
