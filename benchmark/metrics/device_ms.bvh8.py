"""Device ms a render in the BVH8 traversal (bvh8_kernel)."""

import re

BVH8 = re.compile(r"\bbvh8_kernel\b")


def read(trace, session):
    spent = trace.device_s(lambda n: trace.is_port(n) and BVH8.search(n) is not None)
    return 1e3 * spent / trace.units if spent > 0 else None
