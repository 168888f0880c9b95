"""The arithmetic of the end-to-end metrics and of the device trace, on
plain numbers (no device), so that the CPU tests reach all of it."""

from __future__ import annotations


def rate(amount: float, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return amount / seconds


def intervals(completions: list) -> list:
    """The time between each completion and the one before it; the first
    is measured from the window's start, ``completions`` being times since
    that start in increasing order."""
    out, prev = [], 0.0
    for c in completions:
        out.append(c - prev)
        prev = c
    return out


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100) of all values, by linear interpolation
    between the closest ranks (numpy's default rule)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(spans: list) -> float:
    """Length of the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(spans: list, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no span covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: list, t: float):
    """Name of the shortest named span (name, start, end) that holds t,
    or None."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return None if best is None else best[0]
