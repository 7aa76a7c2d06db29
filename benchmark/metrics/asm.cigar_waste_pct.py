"""The share of the parsed CIGARs whose alignment the PAF load threw
away, in %: 100 x (``asm.paf.cigars`` - ``asm.paf.kept``) /
``asm.paf.cigars``, the program's counters over the last ``asm.run``
root of each traced pass.  None where the program has no trace."""


def read(ctx):
    try:
        from haslr_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.roots("asm.run")[-len(ctx["passes"]):]
    counts = [trace.counters_of(r) for r in runs]
    cigars = sum(c.get("asm.paf.cigars", 0) for c in counts)
    kept = sum(c.get("asm.paf.kept", 0) for c in counts)
    if cigars <= 0:
        return None
    return 100.0 * (cigars - kept) / cigars
