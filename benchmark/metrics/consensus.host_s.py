"""Host seconds a pass in the dense consensus engine's glue: its PROF
pack + dispatch + unpack (the wait for the card left out)."""

from benchmark.readers import mean_over_passes


def _host(prof):
    keys = [k for k in prof
            if k in ("pack", "unpack") or k.startswith("dispatch_")]
    return sum(prof[k] for k in keys) if keys else None


def read(ctx):
    return mean_over_passes(ctx, lambda p: _host(p["consensus"]))
