"""Run one cell of the benchmark once and print its result line:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (it exits with code 2 and no result otherwise),
measures the port (``sailor_tpu_torch``) as ``BENCHMARK.json`` describes
the cell, and exits with code 3 if the JAX stack or the JAX package was
loaded, or if the plain reference imports the program.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from benchmark.harness import cell

    sys.exit(cell.main())
