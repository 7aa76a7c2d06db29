"""Seconds a pass inside ``asm.run`` in which the card is idle (no
operation of the device trace runs) and no ``asm.step.*`` span of the
program is open: the card's idle time that the program's spans cannot
name.  The spans' ``time.time_ns()`` stamps are on the profiler's clock.
None where the program has no trace or the card ran nothing."""

from benchmark.readers import union


def _uncovered(lo, hi, covers):
    """Seconds of ``[lo, hi]`` outside the union of ``covers``."""
    inside = sum(min(b, hi) - max(a, lo) for a, b in union(covers)
                 if b > lo and a < hi)
    return hi - lo - inside


def read(ctx):
    try:
        from haslr_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.roots("asm.run")[-len(ctx["passes"]):]
    if not runs or not ctx["events"]:
        return None
    busy = [(e[1], e[2]) for e in ctx["events"]]
    total = 0.0
    for r in runs:
        steps = [(s.start_ns * 1e-9, s.end_ns * 1e-9)
                 for s in trace.spans_of(r)
                 if s.name.startswith("asm.step.")]
        total += _uncovered(r.start_ns * 1e-9, r.end_ns * 1e-9,
                            busy + steps)
    return total / len(runs)
