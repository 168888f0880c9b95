"""The metric arithmetic on made-up numbers: window rate, percentile over
all frames, the union of kernel intervals, idle gaps by host span."""

import numpy as np
import pytest

from benchmark.harness import tracing, window


def test_rate_and_intervals():
    assert window.rate(30.0, 1.5) == 20.0
    assert window.intervals([10.0, 25.0, 27.5]) == [10.0, 15.0, 2.5]
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 60, 75])
def test_percentile_matches_numpy(n):
    v = list(np.random.default_rng(n).gamma(3.0, 200.0, n))
    for q in (50, 95, 99):
        assert window.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert window.union_length(spans) == pytest.approx(3.0)
    assert window.gaps(spans, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert window.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_trace_busy_idle_and_breakdown():
    k = [("void at::native::add", 0.0, 1.0),
         ("void (anonymous namespace)::sweep_kernel<1>(int)", 2.0, 3.0),
         ("void at::native::add", 2.5, 4.0)]
    spans = [("render", 0.0, 6.0), ("wait", 4.5, 6.0)]
    t = tracing.Trace(kernels=k, spans=spans, start=0.0, end=6.0, units=2, counters={})
    assert t.busy_s == pytest.approx(3.0)
    assert t.window_s == 6.0
    assert t.device_s(t.is_port) == pytest.approx(1.0)
    assert t.top_ops()[0] == ["void at::native::add", pytest.approx(2.5)]
    gaps = dict((n, s) for n, s in t.idle_gaps())
    assert gaps == {"render": pytest.approx(1.0), "wait": pytest.approx(2.0)}
