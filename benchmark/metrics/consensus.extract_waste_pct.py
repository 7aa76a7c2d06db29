"""The share of the read bases that the consensus window extraction
decodes and no window keeps, in %: 100 x (``consensus.extract.bases`` -
``consensus.extract.kept``) / ``consensus.extract.bases``, the program's
counters over the last ``asm.run`` root of each traced pass.  None
where the program has no such counters."""


def read(ctx):
    try:
        from haslr_tpu_torch import trace
    except ImportError:
        return None
    runs = trace.roots("asm.run")[-len(ctx["passes"]):]
    counts = [trace.counters_of(r) for r in runs]
    bases = sum(c.get("consensus.extract.bases", 0) for c in counts)
    kept = sum(c.get("consensus.extract.kept", 0) for c in counts)
    if bases <= 0:
        return None
    return 100.0 * (bases - kept) / bases
