"""Seconds a pass in the consensus stage, from the StageTimer log."""

from benchmark.readers import mean_over_passes

CONSENSUS = "calling consensus sequence between anchors..."


def read(ctx):
    return mean_over_passes(ctx, lambda p: p["stages"].get(CONSENSUS))
