"""The consensus round's DP kernel's share of its int32 roofline: B1
(row-scan vote planes) or, under the wavefront engine, B4."""

from benchmark.readers import nw_roofline_pct


def read(ctx):
    return nw_roofline_pct(ctx, {
        "rowscan_votes": ("rowscan_kernel", "VotesEmit"),
        "wavefront_votes": ("wf_walk_kernel", "VotesEmit")})
