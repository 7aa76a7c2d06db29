"""Seconds a pass in the PAF parse (``asm.parse.paf``: the records, their
CIGARs, the filters and the per-read groups), from the program's trace:
the last ``asm.run`` root of each traced pass.  None where the program
has no trace."""


def read(ctx):
    try:
        from haslr_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.roots("asm.run")[-len(ctx["passes"]):]
    if not runs:
        return None
    return sum((s.end_ns - s.start_ns) * 1e-9 for r in runs
               for s in trace.spans_of(r)
               if s.name == "asm.parse.paf") / len(runs)
