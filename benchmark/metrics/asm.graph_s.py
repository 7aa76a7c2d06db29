"""Seconds a pass in every assembler stage but the consensus (loading,
compaction, the backbone graph and its cleaning, coordinates, the
stitch), from the StageTimer log."""

from benchmark.readers import mean_over_passes

CONSENSUS = "calling consensus sequence between anchors..."


def read(ctx):
    return mean_over_passes(ctx, lambda p: sum(
        v for k, v in p["stages"].items() if k != CONSENSUS) or None)
