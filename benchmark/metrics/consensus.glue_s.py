"""Host seconds a pass in the consensus step's per-window work: the
window extraction, encode, plan, pack, unpack, decode and the
``log_consensus.txt`` write (``consensus.windows``, ``.encode``,
``.plan``, ``.pack``, ``.unpack``, ``.decode``, ``.log``), the card's
side (``.dispatch``, ``.wait``) left out; from the program's trace, the
last ``asm.run`` root of each traced pass.  None where the program
records no ``consensus.encode`` span (it has not these spans)."""

SPANS = ("consensus.windows", "consensus.encode", "consensus.plan",
         "consensus.pack", "consensus.unpack", "consensus.decode",
         "consensus.log")


def read(ctx):
    try:
        from haslr_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.roots("asm.run")[-len(ctx["passes"]):]
    spans = [s for r in runs for s in trace.spans_of(r)]
    if not any(s.name == "consensus.encode" for s in spans):
        return None
    return sum((s.end_ns - s.start_ns) * 1e-9 for s in spans
               if s.name in SPANS) / len(runs)
