"""V1's share of its bytes roofline: the bytes its rounds need
(benchmark.counts.vote_tables_bytes) at 3.35 TB/s over the profiler's
device time of vote_tables_kernel."""

from benchmark import counts
from benchmark.readers import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx["events"], "vote_tables_kernel")
    if ctx["v1_bytes"] <= 0 or t <= 0:
        return None
    return 100.0 * counts.bytes_seconds(ctx["v1_bytes"]) / t
