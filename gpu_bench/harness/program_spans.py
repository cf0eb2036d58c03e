"""The program's own spans in the traced segment, and the device's idle
time by the program span the host was in.

The program (``nlos_surface_optimization_torch.utils.timers``) records
spans only while a profiler session records, as the traced segment's
does, on the ``time.perf_counter`` clock that the segment's device
events are mapped onto.  A program that records none (a checkout older
than its spans) gives None, and so does every reader.

``idle_by_span`` splits each idle interval of the device over the
innermost program span open on the host at each instant: one sorted
sweep of the spans into pieces, then one merge of the pieces with the
idle intervals (``trace.breakdown`` names a whole gap by the span at its
midpoint, scanning every span for every gap).
"""

from __future__ import annotations

from collections import defaultdict

from . import trace


def segment_spans(ctx):
    """The program's closed spans inside [trace_t0, trace_t1], or None
    where there is no traced segment or the program records no spans."""
    if ctx.events is None or not ctx.trace_iterations:
        return None
    from nlos_surface_optimization_torch.utils import timers

    read = getattr(timers, "spans", None)
    if read is None:
        return None
    got = [s for s in read()
           if s.t0 >= ctx.trace_t0 and s.t1 <= ctx.trace_t1]
    return got or None


def host_ms_per_iteration(ctx, name):
    """The summed host ms (t1 - t0) of the spans named ``name`` over the
    segment's iterations, or None where there are none.  In a chunk loop
    that the host paces this is the stage's wall time, the device's work
    and the idle it leaves together, not the device's busy time."""
    ms = [s.t1 - s.t0 for s in segment_spans(ctx) or () if s.name == name]
    return 1e3 * sum(ms) / ctx.trace_iterations if ms else None


def innermost_pieces(spans):
    """[(start, end, name)], in time order and disjoint: each instant
    inside some span goes to the innermost one open then.  ``spans`` are
    (name, t0, t1), nested as one thread opens and closes them."""
    pieces, stack, cur = [], [], None

    def close_to(t):
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                pieces.append((cur, end, name))
                cur = end

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        if cur is None:
            cur = a
        close_to(a)
        if stack and a > cur:
            pieces.append((cur, a, stack[-1][1]))
        cur = max(cur, a)
        stack.append((b, name))
    if stack:
        close_to(float("inf"))
    return pieces


def idle_intervals(events, t0, t1):
    """The intervals of [t0, t1] in which no device event ran."""
    out, prev = [], t0
    for a, b in trace.intervals_union(events, t0, t1):
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        out.append((prev, t1))
    return out


def idle_by_span(events, t0, t1, spans) -> dict:
    """{span name: idle seconds} over [t0, t1]: each idle interval split
    over the innermost span open at each instant; idle outside every span
    under None.  ``spans`` are (name, t0, t1)."""
    out = defaultdict(float)
    pieces = innermost_pieces(spans)
    j = 0
    for a, b in idle_intervals(events, t0, t1):
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] += part
                covered += part
            k += 1
        out[None] += (b - a) - covered
    return dict(out)


def idle_ms_per_iteration(ctx, name):
    """The idle ms under ``name`` (as the innermost program span) over the
    segment's iterations, the mean over the cell's cards, or None where
    the program records no spans.  The sweep runs once a card a
    context."""
    spans = segment_spans(ctx)
    if spans is None:
        return None
    idle = getattr(ctx, "_idle_by_program_span", None)
    if idle is None:
        idle = defaultdict(float)
        named = [(s.name, s.t0, s.t1) for s in spans]
        for c in ctx.cards:
            for k, v in idle_by_span(trace.on_card(ctx.events, c),
                                     ctx.trace_t0, ctx.trace_t1,
                                     named).items():
                idle[k] += v / len(ctx.cards)
        ctx._idle_by_program_span = idle
    if not any(s.name == name for s in spans):
        return None
    return 1e3 * idle.get(name, 0.0) / ctx.trace_iterations
