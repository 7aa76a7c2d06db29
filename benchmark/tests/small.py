"""The configurations cut to the size of a CPU test."""

import json


def shrink(share: float, max_repeat: int = 2000):
    """A configuration cut to ``share`` of its replicons' lengths, of its
    long reads' budget and of its repeat copies (two a family at the
    least), with the families longer than ``max_repeat`` left out (their
    consensus windows take minutes in the plain CPU DP), run on one
    thread (the tests' CPU runs, which may run under pytest-xdist, whose
    workers cannot spawn a pool)."""
    def cut(cfg):
        cfg = json.loads(json.dumps(cfg))
        cfg["threads"] = 1
        g = cfg["genome"]
        full = sum(g["replicons"])
        g["replicons"] = [max(60_000, int(x * share)) for x in g["replicons"]]
        g["families"] = [[max(1, int(n * share)), max(2, int(c * share)), L]
                         for n, c, L in g["families"] if L <= max_repeat]
        lr = cfg["long_reads"]
        lr["genome_size"] = int(lr["genome_size"] * sum(g["replicons"])
                                / full)
        return cfg
    return cut


CPU_BASES = 464_000   # the replicon length a cell's CPU run holds


def cpu_share(cfg) -> float:
    """The share that ``shrink`` cuts a configuration's longest replicon
    to for a CPU run: ``CPU_BASES`` over its length, to one significant
    digit and at most 1.  A round share, so that E. coli's 4,641,652 bp
    take 0.1 exactly (an exact quotient may round a base away)."""
    return min(1.0, float(
        f"{CPU_BASES / max(cfg['genome']['replicons']):.1g}"))


def cpu_cut(cfg):
    """The one rule that sizes every cell's CPU run: the configuration's
    longest replicon alone (the long reads' budget cut with it), cut by
    ``shrink`` to its ``cpu_share``.  One replicon, since ``shrink``
    keeps two copies of a repeat family, and a replicon that draws no
    copy is one short-read contig, which forms no path of the backbone
    graph and so is no part of the assembly; the card runs every
    replicon."""
    cfg = json.loads(json.dumps(cfg))
    g, lr = cfg["genome"], cfg["long_reads"]
    longest = max(g["replicons"])
    lr["genome_size"] = int(lr["genome_size"] * longest / sum(g["replicons"]))
    g["replicons"] = [longest]
    return shrink(cpu_share(cfg))(cfg)
