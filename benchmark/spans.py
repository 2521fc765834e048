"""The program's own spans in a traced window: the ``xs.*`` ranges that the
port records with ``torch.profiler.record_function``, as
``tracing.Trace.host`` holds them (name, start, end; microseconds, on the
device trace's clock). In the benchmark's trace they come from the calling
thread only, so they nest cleanly (``xs.call`` > ``xs.compute`` >
``xs.coarse`` ...).

A span's self time is its duration less the union of the ``xs.*`` spans
inside it. Every reading here is None (or empty) when the trace holds no
``xs.*`` span, as a trace of a program without spans does.
"""

from __future__ import annotations

from bisect import bisect_right

from benchmark.tracing import merged, union_us

PREFIX = "xs."


def spans(trace, prefix=PREFIX):
    """``(name, start, end)`` of the spans named ``prefix...`` in the window,
    clipped to it, in order of start."""
    out = [(name, max(s, trace.t0), min(e, trace.t1)) for name, s, e in trace.host
           if name.startswith(prefix)]
    return sorted((x for x in out if x[2] > x[1]), key=lambda x: (x[1], -x[2]))


def self_us(trace):
    """``{name: total self time}`` over the window's ``xs.*`` spans."""
    found = spans(trace)
    starts = [s for _, s, _ in found]
    out = {}
    for i, (name, s, e) in enumerate(found):
        inside = [(s2, e2) for _, s2, e2 in found[i + 1:bisect_right(starts, e)] if e2 <= e]
        out[name] = out.get(name, 0.0) + (e - s) - union_us(inside)
    return out


def union_of(trace, prefix):
    """Time covered by the spans named ``prefix...`` in the window, None
    without ``xs.*`` spans."""
    if not spans(trace):
        return None
    return union_us([(s, e) for _, s, e in spans(trace, prefix)])


def idle_inside_us(trace, name):
    """Device idle time (no kernel, copy or memset) inside the union of the
    spans called ``name``, None without ``xs.*`` spans."""
    if not spans(trace):
        return None
    covered = merged([(s, e) for n, s, e in spans(trace) if n == name])
    busy = merged([(s, e) for _, _, s, e, _ in trace.device])
    overlap, j = 0.0, 0
    for s, e in covered:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return union_us(covered) - overlap
