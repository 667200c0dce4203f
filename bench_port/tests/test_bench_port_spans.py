"""The readers of the program's spans (``host_work_s``, ``defect_host_s``,
``idle_host_pct``) on synthetic runs: self time, tallies, the defect
correction's subtree, and the interval arithmetic that places the spans on
the trace's clock against the device's busy time."""

from types import SimpleNamespace

import pytest

from harness import manifest, spans
from harness.trace import Trace

US = 1000


def _span(name, parent, kind, t0, t1, **attrs):
    return (name, parent, kind, t0 * US, t1 * US, tuple(attrs.items()))


def _solve():
    """One solve's spans, in microseconds: a host hash (0-10), a phase
    holding a launch whose device interval is 20-60, a host LU solve
    (60-80) and a wait (80-90), then a defect correction with a host
    residual (100-130) holding a host child (110-120) and a tally of 3
    occurrences, 6 us in all, over 140-150."""
    return [
        _span("compute_distance", -1, "group", 0, 200),
        _span("cache lookup", 0, "host", 0, 10),
        _span("step 3", 0, "group", 15, 95),
        _span("chunk graph", 2, "launch", 15, 20, device_ns=(20 * US, 60 * US)),
        _span("Gram lu.solve", 2, "host", 60, 80),
        _span("stop state read", 2, "wait", 80, 90),
        _span("f64 defect correction", 0, "group", 95, 160),
        _span("f64 residual (host_op)", 6, "host", 100, 130),
        _span("inner", 7, "host", 110, 120),
        _span("Gram solves", 6, "host", 140, 150, count=3, total_ns=6 * US),
    ]


def _run(stats, device=(), solves=((0, 200 * US),)):
    tr = Trace(sorted(device), [], list(solves))
    return SimpleNamespace(window_stats=stats, trace=tr, notes=[])


def test_self_time_leaves_out_children_and_weighs_tallies():
    s = _solve()
    # 10 + 20 + (30 - 10) + 10 + 6
    assert spans.self_ns(s, spans.HOST) == pytest.approx(66 * US)
    assert spans.self_ns(s, spans.HOST, "defect correction") == pytest.approx(36 * US)
    assert spans.device_intervals(s) == [(20 * US, 60 * US)]
    # one span's own time: the phase less its launch, LU solve and wait
    assert spans.own_pieces(s, 2) == [(20 * US, 60 * US, 1.0), (90 * US, 95 * US, 1.0)]


def test_host_work_and_defect_host_average_over_solves():
    host = manifest.metric_module("host_work_s")
    defect = manifest.metric_module("defect_host_s")
    run = _run([{"spans": _solve()}, {"spans": _solve()[:6]}])
    assert host.read(run) == pytest.approx((66 + 30) / 2 * 1e-6)
    assert defect.read(run) == pytest.approx(36 / 2 * 1e-6)
    # a program without spans, or no correction, gives nothing to read
    assert host.read(_run([{"phases": {}}])) is None
    assert defect.read(_run([{"spans": _solve()[:6]}])) is None


def test_idle_host_places_spans_at_each_marker():
    idle = manifest.metric_module("idle_host_pct")
    # device events: 0-5 and 62-70 us of the first solve; the launch's
    # device interval 20-60 is busy too
    run = _run([{"spans": _solve()}], device=[(0, 5 * US, "k"), (62 * US, 70 * US, "k")])
    # host self time that is idle: hash 5-10 (5), LU solve 60-62 and 70-80
    # (12), residual 100-110 and 120-130 (20), its child (10), the tally
    # 10 x 0.6 (6)
    assert idle.read(run) == pytest.approx(100 * 53 / 200)
    # two solves, the second's marker at 1000 us; with no device event only
    # the launches run: all 66 us of host self time a solve is idle
    two = _run([{"spans": _solve()}, {"spans": _solve()}],
               solves=((0, 500 * US), (1000 * US, 1300 * US)))
    assert idle.read(two) == pytest.approx(100 * 2 * 66 / 1300)
    assert idle.read(_run([{"phases": {}}])) is None


def test_idle_host_never_exceeds_the_idle_share():
    idle = manifest.metric_module("idle_host_pct")
    device_idle = manifest.metric_module("device_idle_pct")
    for device in ([], [(0, 200 * US, "k")], [(30 * US, 75 * US, "k"), (125 * US, 145 * US, "k")]):
        run = _run([{"spans": _solve()}], device=device)
        assert idle.read(run) <= device_idle.read(run) + 1e-9
