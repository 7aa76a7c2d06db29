"""Seconds a pass that the host waits for the card's drafts
(``consensus.wait``: the dense engine's blocking copy back), from the
program's trace: the last ``asm.run`` root of each traced pass.  None
where the program has no trace."""


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
               if s.name == "consensus.wait") / len(runs)
