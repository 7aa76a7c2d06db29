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
