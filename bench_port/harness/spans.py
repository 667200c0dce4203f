"""The program's own spans of a solve, read for the per-layer metrics.

Each solve of the program records ``last_stats["spans"]``: one tuple a
span, ``(name, parent, kind, start_ns, end_ns, attrs)``, start and end on
the host's clock relative to the solve's root span (``parent`` -1), kind
``host`` (host compute awaiting nothing on the device), ``wait`` (the host
blocked on the device), ``launch`` (an enqueue of device work) or
``group``; ``attrs`` (key, value) pairs: a tally's ``count`` and
``total_ns`` (work repeated every iteration, one span from its first start
to its last end), a launch's ``device_ns`` (its CUDA events' offsets from
an event at the root's start, recorded while a profiler runs).  A program
without spans gives nothing to read, and the metrics that read them are
left out of its line.

A traced solve starts right after the harness's marker kernel: its spans
are placed on the trace's clock at the marker's start plus their offsets.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from harness.trace import clip, merge

HOST, WAIT, LAUNCH = "host", "wait", "launch"


def of(stats: Sequence[dict]) -> Optional[List[list]]:
    """Each solve's spans, or None where a solve has none."""
    out = [s.get("spans") for s in stats]
    return out if out and all(out) else None


def _within(spans, i: int, under: Optional[str]) -> bool:
    if under is None:
        return True
    p = spans[i][1]
    while p >= 0:
        if under in spans[p][0]:
            return True
        p = spans[p][1]
    return False


def self_pieces(spans, kind: str, under: Optional[str] = None) -> List[Tuple[int, int, float]]:
    """(start, end, weight) of the self time of each span of ``kind``: its
    interval less the intervals of its children.  A tally's pieces weigh
    its total over its interval (its occurrences fill that share of it).
    ``under``: only the spans with an ancestor whose name holds it."""
    children: dict = {}
    for name, parent, k, t0, t1, attrs in spans:
        children.setdefault(parent, []).append((t0, t1))
    out = []
    for i, (name, parent, k, t0, t1, attrs) in enumerate(spans):
        if k != kind or t1 <= t0 or not _within(spans, i, under):
            continue
        a = dict(attrs)
        w = min(1.0, a["total_ns"] / (t1 - t0)) if "total_ns" in a else 1.0
        edges = [t0]
        for c0, c1 in merge(clip(children.get(i, ()), t0, t1)):
            edges += [c0, c1]
        edges.append(t1)
        out += [(edges[j], edges[j + 1], w) for j in range(0, len(edges), 2)
                if edges[j + 1] > edges[j]]
    return out


def own_pieces(spans, i: int) -> List[Tuple[int, int, float]]:
    """``self_pieces`` of span ``i`` alone: its interval less its
    children's."""
    name, _, kind, t0, t1, attrs = spans[i]
    return self_pieces([(name, -1, kind, t0, t1, attrs)] + [
        (c, 0, "child", a, b, ()) for c, p, _, a, b, _ in spans if p == i], kind)


def self_ns(spans, kind: str, under: Optional[str] = None) -> float:
    """The summed self time of the spans of ``kind`` (a tally's total)."""
    return sum((b - a) * w for a, b, w in self_pieces(spans, kind, under))


def device_intervals(spans) -> List[Tuple[int, int]]:
    """The device intervals of the launch spans that recorded CUDA events."""
    out = []
    for name, parent, kind, t0, t1, attrs in spans:
        d = dict(attrs).get("device_ns")
        if kind == LAUNCH and d is not None:
            out.append((int(d[0]), int(d[1])))
    return out


def idle_overlap_ns(pieces: Sequence[Tuple[int, int, float]],
                    busy: Sequence[Tuple[int, int]], lo: int, hi: int) -> float:
    """The weighted time of ``pieces`` in [lo, hi) in which none of
    ``busy`` runs."""
    busy = merge(clip(busy, lo, hi))
    starts = [a for a, _ in busy]
    total = 0.0
    for a, b, w in pieces:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        covered = 0
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(busy) and busy[j][0] < b:
            covered += max(0, min(b, busy[j][1]) - max(a, busy[j][0]))
            j += 1
        total += w * (b - a - covered)
    return total
