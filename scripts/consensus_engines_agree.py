"""The JAX package's two consensus engines on the consensus workload.

Runs ``haslr_tpu.kernels.consensus.batched_consensus`` with the dense
engine, then with the chunked engine under each NW engine
(``haslr_tpu.kernels.nw.ENGINE``), on the 4096 windows of ``bench.py``'s
generator (its copy ``chip_smoke.make_windows``, which needs no jax), and
prints one JSON line: each run's seconds and the windows whose chunked
output differs from the dense one.  ``chip_smoke.py`` phase 13 holds the
port's chunked engine to the dense output on every window; this shows
whether the reference's engines agree there too.

Usage: JAX_PLATFORMS=cpu python scripts/consensus_engines_agree.py [N]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(n_windows: int = 4096) -> dict:
    import chip_smoke
    from haslr_tpu.kernels import nw
    from haslr_tpu.kernels.consensus import batched_consensus

    windows = chip_smoke.make_windows(n_windows=n_windows)
    rec = {"windows": n_windows}
    t0 = time.time()
    dense = batched_consensus(windows, engine="dense")
    rec["dense_s"] = time.time() - t0
    old = nw.ENGINE
    try:
        for engine in ("rowscan", "wavefront"):
            nw.ENGINE = engine
            t0 = time.time()
            chunked = batched_consensus(windows, engine="chunked")
            rec[f"chunked_{engine}_s"] = time.time() - t0
            rec[f"chunked_{engine}_windows_differing"] = [
                i for i, (a, b) in enumerate(zip(dense, chunked)) if a != b
            ]
    finally:
        nw.ENGINE = old
    return rec


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:]))))
