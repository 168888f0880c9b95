"""Where chip_smoke.py's time goes: runs the ``chip_smoke.py`` of the
current directory with each of its module functions timed, and prints on
standard error, after the script's own output, the seconds of each
function called from ``main`` (summed over its calls, largest first) and
of each call. Not a test; from the root of a checkout, on one card:

    python3 tests/torch_smoke_phases.py
    cd OTHER_CHECKOUT && python3 /path/to/tests/torch_smoke_phases.py

so that two checkouts (a change and its parent, unpacked with ``git
archive``) can be timed in one call. Exits with chip_smoke's code.
"""

import json
import os
import sys
import time
import types


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    depth = [0]
    times: dict = {}

    def timed(name, fn):
        def run(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:  # called from main, not from another timed function
                    times.setdefault(name, []).append(round(time.perf_counter() - t0, 2))
        return run

    for name, fn in list(vars(cs).items()):
        if (isinstance(fn, types.FunctionType) and fn.__module__ == "chip_smoke"
                and name not in ("main", "check", "_card", "_wall_ms", "_time_ms")):
            setattr(cs, name, timed(name, fn))
    try:
        return cs.main()
    finally:
        total = {k: round(sum(v), 2) for k, v in times.items()}
        print("PHASES " + json.dumps(dict(sorted(total.items(), key=lambda kv: -kv[1]))),
              file=sys.stderr)
        print("PHASES_ALL " + json.dumps(times), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
