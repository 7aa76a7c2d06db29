"""Probe and timings of the PyTorch/CUDA port's wavefront kernels
(``haslr_tpu_torch/csrc/wavefront.cu``) on one NVIDIA GPU.  Needs nvcc and
a CUDA device.

    python3 scripts/torch_wavefront_probe.py probe
    python3 scripts/torch_wavefront_probe.py variants
    python3 scripts/torch_wavefront_probe.py times
    python3 scripts/torch_wavefront_probe.py routes

``probe`` builds the source with ``-DHX_PROBE`` (``clock64()`` stamps
around the DP and the walk of the mapping kernel, and a DP-only switch)
and prints, per shape: the launch's ms (CUDA events), the DP-only ms, and
the mean cycles a diagonal of the DP and of the walk.  ``variants`` runs
the same probe on builds without the DP's direction stores
(``-DHX_PROBE_NO_STORE``), without its code-word refills
(``-DHX_PROBE_NO_REFILL``) and without both: what is left is the DP's own
arithmetic (their outputs are wrong; only the stamps are read).
``times`` times the three wavefront wrappers and the row-scan votes and
CIGAR wrappers on the same tensors (best of two turns of five launches).
``routes`` times the mapping, votes and CIGAR kernels of both engines at
512 lanes under each of their two routes, on launches around the
small-launch limit.

Nothing here is on the port's path; the probe builds go to a temporary
directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from haslr_tpu_torch.kernels import _build  # noqa: E402
from haslr_tpu_torch.kernels import nw_rowscan as rs  # noqa: E402
from haslr_tpu_torch.kernels import nw_wavefront as wf  # noqa: E402

PROBE_SHAPES = ((2048, 512, 128), (2048, 1024, 128), (256, 4096, 512),
                (32, 16384, 512), (32, 512, 128))
TIMES_SHAPES = ((2048, 512, 128), (2048, 1024, 128), (1024, 2048, 256),
                (32, 16384, 512), (4096, 256, 128), (600, 512, 128),
                (256, 4096, 512), (128, 8192, 512), (53248, 512, 128))
ROUTE_SHAPES = ((64, 4096), (128, 4096), (256, 4096), (384, 4096),
                (512, 4096), (256, 2048), (512, 2048), (1024, 1024))
VARIANTS = (("as built", ()), ("no stores", ("-DHX_PROBE_NO_STORE",)),
            ("no refills", ("-DHX_PROBE_NO_REFILL",)),
            ("neither", ("-DHX_PROBE_NO_STORE", "-DHX_PROBE_NO_REFILL")))


def build_probe(out_dir, name, defines=()):
    """``wavefront.cu`` with ``-DHX_PROBE`` and ``defines``, loaded."""
    so = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-DHX_PROBE",
                    *defines, "-o", so,
                    os.path.join(_build.CSRC, "wavefront.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.hx_set_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hx_wavefront_mapping.argtypes = \
        _build._SIGNATURES["hx_wavefront_mapping"]
    return lib


def ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def best(fn):
    return round(min(ms(fn), ms(fn)), 4)


def batch(dev, B, S):
    """``chip_smoke.mutated_batch`` without pad rows; above 4096 reads, a
    4096-read batch repeated."""
    rng = np.random.default_rng(S + 2)
    arrays = cs.mutated_batch(rng, min(B, 4096), S, pad_rows=0)
    if B > 4096:
        arrays = [np.concatenate([a] * (B // 4096)) for a in arrays]
    return cs._to(dev, *arrays)


def probe(dev, lib, shapes=PROBE_SHAPES, tag=None):
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, W in shapes:
        args = batch(dev, B, S)
        mapping = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        stamps = torch.zeros((B, 3), dtype=torch.int64, device=dev)
        C, wpr, rpb = wf._route(W, B, rs._sm_count(dev))
        base = wf._base_tensor(S, S, W, dev)
        scratch = torch.empty(B * wf._per_read(S, S, 32 * C * wpr),
                              dtype=torch.uint8, device=dev)

        def run():
            err = lib.hx_wavefront_mapping(
                *(a.data_ptr() for a in args), base.data_ptr(),
                scratch.data_ptr(), mapping.data_ptr(), B, S, S, W, 2, -4,
                -2, S, S, C, wpr, rpb, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        def timed(dp_only):
            torch.cuda.synchronize()
            lib.hx_set_probe(stamps.data_ptr(), dp_only)
            return min(ms(run), ms(run))

        full, dp_only = timed(0), timed(1)
        full = min(full, timed(0))
        s = stamps.cpu().numpy().astype(np.float64)
        print(json.dumps({
            **({"variant": tag} if tag else {}),
            "B": B, "S": S, "W": W, "route": f"C={C} WPR={wpr}",
            "full_ms": full, "dp_only_ms": dp_only,
            "walk_share_ms": 1 - dp_only / full,
            "dp_cycles_a_read": s[:, 0].mean(),
            "walk_cycles_a_read": s[:, 1].mean(),
            "diagonals_a_read": s[:, 2].mean(),
            "dp_cycles_a_diagonal": s[:, 0].sum() / s[:, 2].sum(),
            "walk_cycles_a_diagonal": s[:, 1].sum() / s[:, 2].sum(),
            "walk_share_cycles": s[:, 1].sum() / s[:, :2].sum(),
        }), flush=True)


def times(dev):
    for B, S, W in TIMES_SHAPES:
        args = batch(dev, B, S)
        rec = {"B5_ms": best(lambda: wf.wavefront_mapping(*args, W, 2, -4,
                                                          -2)),
               "B4_ms": best(lambda: wf.wavefront_votes(*args, W, 5, -4,
                                                        -8))}
        if B * (2 * S + 1) * W < (3 << 30):  # the whole tensor on the card
            rec["B6_ms"] = best(lambda: wf.wavefront_dirs(*args, W, 5, -4,
                                                          -8))
        rec["B2_ms"] = best(lambda: rs.rowscan_cigar(*args, W, 2, -4, -2,
                                                     max(128, S // 4)))
        rec["B1_ms"] = best(lambda: rs.rowscan_votes(*args, W, 5, -4, -8))
        print(json.dumps({"B": B, "S": S, "W": W, **rec}), flush=True)


def routes(dev):
    """Each route at 512 lanes, through ``launch_chunked`` as the wrappers
    go, with the route given here and not picked by the launch size."""
    W = 512
    counts = {n: 0 for n in ("wavefront_mapping", "wavefront_votes",
                             "rowscan_cigar", "rowscan_votes")}
    for B, S in ROUTE_SHAPES:
        args = batch(dev, B, S)
        maxr = max(128, S // 4)
        mapping = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        planes = torch.full((B, 3 * S + 256), 4, dtype=torch.uint8,
                            device=dev)
        stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
        runs = torch.zeros((B, maxr), dtype=torch.int32, device=dev)
        n_runs = torch.empty(B, dtype=torch.int32, device=dev)
        votes_out = ((planes, 3 * S + 256), (stats, 8))
        rec = {}
        for C, wpr in rs.ROUTES[W]:
            rpb = 1
            while wpr == 1 and rpb < rs.MAX_READS_PER_BLOCK \
                    and rpb * rs._sm_count(dev) < B:
                rpb *= 2
            lanes = 32 * C * wpr

            def go(name, base, per_read, outs, scores):
                return best(lambda: rs.launch_chunked(
                    name, counts, *args, W, base, per_read, outs, scores))

            wf_base = wf._base_tensor(S, S, W, dev)
            wf_per = wf._per_read(S, S, lanes)
            rs_base = rs._base_tensor(S, S, W, S, dev)
            rs_per = rs.packed_bytes(S, lanes)
            rec[f"C={C} WPR={wpr}"] = {
                "B5_ms": go("wavefront_mapping", wf_base, wf_per,
                            ((mapping, 4 * S),),
                            (2, -4, -2, S, S, C, wpr, rpb)),
                "B4_ms": go("wavefront_votes", wf_base, wf_per, votes_out,
                            (5, -4, -8, S, S, C, wpr, rpb)),
                "B2_ms": go("rowscan_cigar", rs_base, rs_per,
                            ((runs, 4 * maxr), (n_runs, 4)),
                            (2, -4, -2, maxr, C, wpr, rpb)),
                "B1_ms": go("rowscan_votes", rs_base, rs_per, votes_out,
                            (5, -4, -8, C, wpr, rpb)),
            }
        print(json.dumps({"B": B, "S": S, "W": W, "routes": rec}),
              flush=True)


def main(argv):
    if len(argv) != 1 or argv[0] not in ("probe", "variants", "times",
                                         "routes"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_wavefront_probe: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(cs._smi(), flush=True)
    if argv[0] == "times":
        return times(dev)
    if argv[0] == "routes":
        return routes(dev)
    with tempfile.TemporaryDirectory(prefix="wf_probe_") as tmp:
        if argv[0] == "probe":
            return probe(dev, build_probe(tmp, "probe"))
        for tag, defines in VARIANTS:
            probe(dev, build_probe(tmp, tag.replace(" ", "_"), defines),
                  ((32, 512, 128), (2048, 512, 128)), tag)


if __name__ == "__main__":
    main(sys.argv[1:])
