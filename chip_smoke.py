"""Smoke run of the PyTorch/CUDA port (haslr_tpu_torch) on one NVIDIA GPU.

Phases, one printed line each (any failure raises):

1. the card (``nvidia-smi`` name and power limit) and the torch device;
2. build of the CUDA kernels from ``haslr_tpu_torch/csrc`` (one nvcc per
   source, in parallel, sm_90a);
3. each of the six kernels against its plain PyTorch version on the
   card, exact, at the shapes its callers give it; the three row-scan
   kernels again at every route of their design (lanes a thread, warps a
   read: W = 128, 256, and 512 at launches on either side of the small-
   launch limit; ragged, empty, out-of-gate and pad rows, the
   MAXR-overflow batch, and S=16384/W=512 at 32 reads) and at bands and
   row widths off the main path (W = 32 to 480, R and D no multiples of
   four); then each kernel's time (CUDA events) beside its plain
   version's and its bound on this card;
4. the golden assembly (``tests/golden``) through the CUDA consensus,
   byte for byte;
5. the consensus workload (4096 windows x 13 reads x ~300 bp at 6 %
   error): windows/s on the card beside the native POA on one CPU core,
   and the card's output equal to the CPU plain path's on 256 windows;
6. the five-stage pipeline (``haslr_tpu_torch.cli.haslr``) end to end on
   a simulated 4.6 Mb genome: stage times, contigs, NG50, interior 31-mer
   recall, the kernel launch counts of that run, and the CIGAR-run
   kernel's launches by bucket (S, W, launches, reads, device ms);

then the same paths under the wavefront engine (``nw.ENGINE =
"wavefront"``, restored after each phase):

7. the oracle: ``nw.banded_nw_batch`` + ``traceback_batch`` equal to
   ``nw.align_mapping_device`` (wavefront) on 4096 in-gate reads at two
   shapes, and how many rows the row-scan engine's mapping differs in;
8. the golden assembly again, byte for byte;
9. the consensus workload: windows/s, the card equal to the CPU plain
   path on 256 windows, and how many windows differ from phase 5's;
10. the 4.6 Mb pipeline resumed from phase 6's output without its PAF and
    assembly, so that the aligner and the assembler run again: stage
    times, contigs, NG50, recall, launches, and whether ``asm.final.fa``
    equals phase 6's.

The bound of a kernel is the larger of its bytes (inputs read once,
outputs written once) over 3.35 TB/s and its int32 operations on this
run's inputs over 132 SMs x 64 lanes x 1.98 GHz (``kernel_bound``).

Then a JSON line of kernel records, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Needs one CUDA
device, the CUDA toolkit (nvcc) and g++; exits non-zero without them.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = "exact (integer DP scores and vote counts)"
E2E_SCALE = 4_600_000  # bp: the JAX package's recorded 4.6 Mb tier

# kernel: (source, the TPU kernel it replaces, the path whose run counts
# its launches)
KERNELS = {
    "rowscan_votes": ("haslr_tpu_torch/csrc/rowscan.cu",
                      "haslr_tpu/kernels/nw_rowscan.py:469", "e2e"),
    "rowscan_cigar": ("haslr_tpu_torch/csrc/rowscan.cu",
                      "haslr_tpu/kernels/nw_rowscan.py:692", "e2e"),
    "rowscan_mapping": ("haslr_tpu_torch/csrc/rowscan.cu",
                        "haslr_tpu/kernels/nw_rowscan.py:422", "oracle"),
    "wavefront_votes": ("haslr_tpu_torch/csrc/wavefront.cu",
                        "haslr_tpu/kernels/nw_pallas.py:266", "e2e_wf"),
    "wavefront_mapping": ("haslr_tpu_torch/csrc/wavefront.cu",
                          "haslr_tpu/kernels/nw_pallas.py:208", "e2e_wf"),
    "wavefront_dirs": ("haslr_tpu_torch/csrc/wavefront.cu",
                       "haslr_tpu/kernels/nw_pallas.py:201", "oracle"),
}


# the least time the card could take: HBM3 bytes/s, and int32 add / max /
# compare issued on 64 lanes an SM (half the 33.5 T instructions/s behind
# the published 67 TFLOP/s of float32)
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 132 * 64 * 1.98e9
# int32 operations a DP cell, as each recurrence is written.  Row-scan:
# substitution score (compare, select), two candidate adds, their max, the
# valid mask (compare, select), the -gap*k shift, the scan max, the +gap*k
# shift, the direction (two compares, two selects).  Wavefront: the score
# (2), three candidate adds, their three gates (i >= 1, j >= 1: two
# compares, three selects), two maxes, the direction (4), the valid mask
# (compare, select).
OPS_PER_CELL = {"rowscan": 14, "wavefront": 18}


def kernel_bound(name, r_lens, d_lens, R, D, W, in_bytes, out_bytes):
    """``(bound_ms, bound_by)`` of kernel ``name`` on one batch: what
    these inputs need, not the most the shape could.  The row-scan DP
    fills r_len rows of W lanes a read; the wavefront mapping and votes
    kernels r_len + d_len diagonals; the wavefront dirs kernel all R + D."""
    engine = name.split("_")[0]
    if engine == "rowscan":
        rows = int(r_lens.clamp(0, R).sum())
    elif name == "wavefront_dirs":
        rows = len(r_lens) * (R + D)
    else:
        rows = int((r_lens.clamp(0, R) + d_lens.clamp(0, D)).sum())
    ops_ms = rows * W * OPS_PER_CELL[engine] / PEAK_INT32_S * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def _counters():
    from haslr_tpu_torch.kernels import nw_rowscan, nw_wavefront

    return nw_rowscan.LAUNCHES, nw_wavefront.LAUNCHES


def reset_launches():
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def launches():
    rs, wf = _counters()
    return {**rs, **wf}


@contextlib.contextmanager
def launch_log():
    """Every kernel launch of the block, with CUDA events around each:
    yields a list that holds, once the block has ended, one record a
    (kernel, S, W) bucket: launches, reads and device ms."""
    import torch

    from haslr_tpu_torch.kernels import nw_rowscan as rs

    out = []
    rs.LAUNCH_LOG = []
    try:
        yield out
        torch.cuda.synchronize()
        buckets = {}
        for name, n, R, W, ev0, ev1 in rs.LAUNCH_LOG:
            b = buckets.setdefault((name, R, W), {
                "kernel": name, "S": R, "W": W, "launches": 0, "reads": 0,
                "device_ms": 0.0})
            b["launches"] += 1
            b["reads"] += n
            b["device_ms"] += ev0.elapsed_time(ev1)
        out.extend(buckets[k] for k in sorted(buckets))
    finally:
        rs.LAUNCH_LOG = None


@contextlib.contextmanager
def nw_engine(name):
    """The port's NW engine set to ``name`` for the block, restored
    after it."""
    from haslr_tpu_torch.kernels import nw

    old = nw.ENGINE
    nw.ENGINE = name
    try:
        yield
    finally:
        nw.ENGINE = old


def _line(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields), flush=True)


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def mutated_batch(rng, B, S, pad_rows=4, sub=0.04, ins=0.03, dele=0.03,
                  gate_w=None):
    """Reads mutated from random drafts (the reference tests' batches);
    rows 0 and 1 are out of the admission gate, the last ``pad_rows``
    rows pure padding (r_len = d_len = 0).  With ``gate_w`` every row is
    cut to lie inside the gate |r_len - d_len| < gate_w/2 - 4 instead."""
    import numpy as np

    reads = np.full((B, S), 4, np.uint8)
    drafts = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    for b in range(B - pad_rows):
        dl = int(rng.integers(50, S - 10))
        d = rng.integers(0, 4, dl).astype(np.uint8)
        x = rng.random(dl)
        extra = rng.integers(0, 4, dl).astype(np.uint8)
        r = []
        for p in range(dl):
            if x[p] < dele:
                continue
            if x[p] < dele + ins:
                r.append(int(extra[p]))
            if x[p] < dele + ins + sub:
                r.append(int(extra[p]))
                continue
            r.append(int(d[p]))
        r = np.array(r[:S], np.uint8)
        reads[b, : len(r)] = r
        drafts[b, :dl] = d
        r_lens[b] = len(r)
        d_lens[b] = dl
    if gate_w is not None:
        slack = gate_w // 2 - 5
        r_lens = np.minimum(r_lens, d_lens + slack).astype(np.int32)
        d_lens = np.minimum(d_lens, r_lens + slack).astype(np.int32)
        col = np.arange(S)[None, :]
        reads[col >= r_lens[:, None]] = 4
        drafts[col >= d_lens[:, None]] = 4
        return reads, r_lens, drafts, d_lens
    r_lens[0] = min(int(r_lens[0]), 60)
    d_lens[0] = max(int(d_lens[0]), 60 + S // 4)
    r_lens[1], d_lens[1] = d_lens[1], r_lens[1]
    return reads, r_lens, drafts, d_lens


def overflow_batch(rng, B, S):
    """Indel-dense reads (an insertion after every other base of the
    first 80) that need more CIGAR runs than a small MAXR."""
    import numpy as np

    reads = np.full((B, S), 4, np.uint8)
    drafts = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.zeros(B, np.int32)
    for b in range(B):
        d = rng.integers(0, 4, 150).astype(np.uint8)
        r = []
        for p, ch in enumerate(d):
            r.append(int(ch))
            if p % 2 == 0 and p < 80:
                r.append(int(rng.integers(0, 4)))
        reads[b, : len(r)] = r
        drafts[b, :150] = d
        r_lens[b] = len(r)
        d_lens[b] = 150
    return reads, r_lens, drafts, d_lens


def _to(dev, *arrays):
    import torch

    return [torch.from_numpy(a).to(dev) for a in arrays]


def _max_err(pairs):
    """Max |kernel - plain| over tensor pairs; raises on any difference."""
    worst = 0
    for name, a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {a.shape} != {b.shape}")
        err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        if err:
            raise AssertionError(f"{name}: kernel != plain (max |d| {err})")
        worst = max(worst, err)
    return worst


def check_shape(dev, R, D, W, B, seed, overflow=False):
    """B1, B2 and B3 on the card at one shape against their plain
    versions, every row and every slot, exact; returns the (C, WPR) route
    the wrappers took."""
    import numpy as np

    from haslr_tpu_torch.kernels import nw_rowscan as rs

    rng = np.random.default_rng(seed)
    reads, r_lens, drafts, d_lens = overflow_batch(rng, B, D) if overflow \
        else mutated_batch(rng, B, D)
    reads = np.pad(reads, ((0, 0), (0, R - D)), constant_values=4)
    r_lens[2] = R + 1  # longer than its row: a full DP and no walk
    args = _to(dev, reads, r_lens, drafts, d_lens)
    maxr = 64 if overflow else max(128, R // 4)
    runs_p, n_p = rs.rowscan_cigar_plain(*args, W, 2, -4, -2, maxr)
    if overflow and not bool((n_p > maxr).any()):
        raise AssertionError("overflow batch did not overflow MAXR")
    planes_p, stats_p = rs.rowscan_votes_plain(*args, W, 5, -4, -8)
    map_p = rs.rowscan_mapping_plain(*args, W, 5, -4, -8)
    runs_k, n_k = rs.rowscan_cigar(*args, W, 2, -4, -2, maxr)
    planes_k, stats_k = rs.rowscan_votes(*args, W, 5, -4, -8)
    map_k = rs.rowscan_mapping(*args, W, 5, -4, -8)
    what = f"R={R} D={D} W={W} B={B}"
    _max_err([(f"n_runs {what}", n_k, n_p), (f"runs {what}", runs_k, runs_p),
              (f"planes {what}", planes_k, planes_p),
              (f"stats {what}", stats_k, stats_p),
              (f"mapping {what}", map_k, map_p)])
    return rs._route(W, B, rs._sm_count(dev))[:2]


def check_votes(dev, S, W, B, seed, engine="rowscan"):
    """B1 (``engine="rowscan"``) or B4 (``"wavefront"``) on the card vs
    its plain version: planes, stats and the reduced vote tables, every
    row (in and out of the gate, pad rows)."""
    import numpy as np
    import torch

    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf

    kern, plain = {
        "rowscan": (rs.rowscan_votes, rs.rowscan_votes_plain),
        "wavefront": (wf.wavefront_votes, wf.wavefront_votes_plain),
    }[engine]
    rng = np.random.default_rng(seed)
    args = _to(dev, *mutated_batch(rng, B, S))
    planes_k, stats_k = kern(*args, W, 5, -4, -8)
    planes_p, stats_p = plain(*args, W, 5, -4, -8)
    N = 8
    win = torch.from_numpy(rng.integers(0, N, B)).to(dev)
    r_lens, d_lens = args[1], args[3]
    ok = (r_lens > 0) & (d_lens > 0) & ((r_lens - d_lens).abs() < W // 2 - 4)
    tabs_k = cd._vote_tables(planes_k, stats_k, win, ok, N, S)
    tabs_p = cd._vote_tables(planes_p, stats_p, win, ok, N, S)
    names = ("counts", "cov_diff", "ins1", "ins2", "n_reads")
    return _max_err(
        [("planes", planes_k, planes_p), ("stats", stats_k, stats_p)]
        + [(n, a, b) for n, a, b in zip(names, tabs_k, tabs_p)]
    )


def check_cigar(dev, S, W, B, seed, maxr=None, overflow=False):
    """B2 on the card vs its plain version: run counts and run slots."""
    import numpy as np

    from haslr_tpu_torch.kernels import nw_rowscan as rs

    rng = np.random.default_rng(seed)
    batch = overflow_batch(rng, B, S) if overflow else \
        mutated_batch(rng, B, S)
    args = _to(dev, *batch)
    maxr = maxr or max(128, S // 4)
    runs_k, n_k = rs.rowscan_cigar(*args, W, 2, -4, -2, maxr)
    runs_p, n_p = rs.rowscan_cigar_plain(*args, W, 2, -4, -2, maxr)
    if overflow and not bool((n_k > maxr).any()):
        raise AssertionError("overflow batch did not overflow MAXR")
    return _max_err([("n_runs", n_k, n_p), ("runs", runs_k, runs_p)])


def _plain_pairs():
    """kernel name -> (wrapper, plain version, scores) for B3, B5, B6."""
    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf

    return {
        "rowscan_mapping": (rs.rowscan_mapping, rs.rowscan_mapping_plain,
                            (5, -4, -8)),
        "wavefront_mapping": (wf.wavefront_mapping,
                              wf.wavefront_mapping_plain, (2, -4, -2)),
        "wavefront_dirs": (wf.wavefront_dirs, wf.wavefront_dirs_plain,
                           (5, -4, -8)),
    }


def check_plain(dev, name, S, W, B, seed):
    """B3, B5 or B6 on the card vs its plain version, every row (in and
    out of the gate, pad rows) and, for B6, every cell."""
    import numpy as np

    kern, plain, scores = _plain_pairs()[name]
    rng = np.random.default_rng(seed)
    args = _to(dev, *mutated_batch(rng, B, S))
    return _max_err([(name, kern(*args, W, *scores),
                      plain(*args, W, *scores))])


def time_pair(dev, S, W, B, seed, only=None, plain_once=False):
    """Per kernel (all six, or those in ``only``) at one shape: kernel ms
    and plain ms (CUDA events around warm launches, the two versions
    interleaved; ``plain_once``: the plain version a single cold call,
    for shapes where it takes seconds), the bound on this batch and the
    share of it reached."""
    import numpy as np
    import torch

    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf

    rng = np.random.default_rng(seed)
    args = _to(dev, *mutated_batch(rng, B, S, pad_rows=0))

    def ms(fn, n, warm=True):
        if warm:
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

    maxr = max(128, S // 4)
    out = {}
    for name, kern, plain, extra in (
        ("rowscan_votes", rs.rowscan_votes, rs.rowscan_votes_plain,
         (5, -4, -8)),
        ("rowscan_cigar", rs.rowscan_cigar, rs.rowscan_cigar_plain,
         (2, -4, -2, maxr)),
        ("wavefront_votes", wf.wavefront_votes, wf.wavefront_votes_plain,
         (5, -4, -8)),
        *((k, *v) for k, v in _plain_pairs().items()),
    ):
        if only is not None and name not in only:
            continue
        p1 = ms(lambda: plain(*args, W, *extra), 1, warm=not plain_once)
        k1 = ms(lambda: kern(*args, W, *extra), 5)
        k2 = ms(lambda: kern(*args, W, *extra), 5)
        p2 = p1 if plain_once else ms(lambda: plain(*args, W, *extra), 1)
        res = kern(*args, W, *extra)
        res = res if isinstance(res, tuple) else (res,)
        bound_ms, bound_by = kernel_bound(
            name, args[1], args[3], S, S, W,
            sum(a.numel() * a.element_size() for a in args),
            sum(o.numel() * o.element_size() for o in res),
        )
        del res
        out[name] = {
            "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / min(k1, k2),
            "mean_r_len": float(args[1].float().mean()),
        }
    return out


def make_windows(seed=0, n_windows=4096, n_support=13, win_len=300,
                 error_rate=0.06):
    """The consensus benchmark's windows (a copy of ``bench.py``'s
    generator, which imports jax)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = "ACGT"

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < error_rate / 3:
                continue
            if r < 2 * error_rate / 3:
                out.append(bases[rng.integers(0, 4)])
            else:
                out.append(ch)
                if r < error_rate:
                    out.append(bases[rng.integers(0, 4)])
        return "".join(out)

    windows = []
    for _ in range(n_windows):
        L = int(rng.integers(win_len * 2 // 3, win_len * 4 // 3))
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(n_support)])
    return windows


def phase_golden(dev, tmp, out_name="golden_asm"):
    """The port's run_assembler on the golden input reproduces the
    reference's pinned device-engine outputs byte for byte (under either
    NW engine)."""
    from haslr_tpu_torch.config import AssembleConfig
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    gold = os.path.join(ROOT, "tests", "golden")
    paths = {}
    for name in ("contigs.fa", "lr.fa", "map.paf"):
        paths[name] = os.path.join(tmp, name)
        with gzip.open(f"{gold}/input/{name}.gz", "rb") as fi, \
                open(paths[name], "wb") as fo:
            fo.write(fi.read())
    out = os.path.join(tmp, out_name)
    t0 = time.time()
    with open(os.devnull, "w") as log:
        run_assembler(paths["contigs.fa"], paths["lr.fa"], paths["map.paf"],
                      out, cfg=AssembleConfig(consensus_engine="tpu"),
                      log=log, device=dev)
    for name in ("asm.final.fa", "asm.final.ann"):
        with open(f"{gold}/expected/tpu.{name}", "rb") as f:
            want = f.read()
        with open(f"{out}/{name}", "rb") as f:
            if f.read() != want:
                raise AssertionError(f"golden {name} differs")
    return time.time() - t0


def phase_consensus(dev, windows, n_check=256, n_poa=512):
    """Windows/s of the port's consensus on ``dev`` and of the native POA
    on one core; the card's output equals the CPU plain path's on
    ``n_check`` windows.  Returns (record, the card's consensus)."""
    import torch

    from haslr_tpu_torch import native
    from haslr_tpu_torch.core import seq as cseq
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    code_wins = [[cseq.encode(s) for s in w] for w in windows[:n_poa]]
    native.poa_consensus_native(code_wins[:2])  # build / load the library
    t0 = time.time()
    native.poa_consensus_native(code_wins, n_threads=1)
    poa_rate = len(code_wins) / (time.time() - t0)

    batched_consensus(windows[:64], device=dev)  # first-call warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with launch_log() as by_bucket:
        t0 = time.time()
        out = batched_consensus(windows, device=dev)
        dt = time.time() - t0
    sub = windows[:n_check]
    on_dev = batched_consensus(sub, device=dev)
    on_cpu = batched_consensus(sub, device="cpu")
    if on_dev != on_cpu or on_dev != out[:n_check]:
        raise AssertionError("consensus on the card != CPU plain path")
    if not any(b["kernel"] == "rowscan_votes" for b in by_bucket):
        raise AssertionError("row-scan consensus launched no B1 kernel")
    return {
        "windows": len(windows), "windows_per_s": len(windows) / dt,
        "seconds": dt, "launches_by_bucket": by_bucket,
        "poa_1core_windows_per_s": poa_rate,
        "poa_windows": len(code_wins), "cpu_plain_equal_windows": n_check,
    }, out


def phase_consensus_wavefront(dev, windows, rowscan_out, n_check=256):
    """The consensus workload under the wavefront engine: windows/s, the
    card's output equal to the CPU plain path's on ``n_check`` windows,
    and the count of windows whose consensus differs from the row-scan
    engine's (a fact, not a check: the two bands differ)."""
    import torch

    from haslr_tpu_torch.kernels.consensus import batched_consensus

    with nw_engine("wavefront"):
        batched_consensus(windows[:64], device=dev)  # first-call warm-up
        torch.cuda.synchronize()
        reset_launches()
        with launch_log() as by_bucket:
            t0 = time.time()
            out = batched_consensus(windows, device=dev)
            dt = time.time() - t0
        n_launch = launches()["wavefront_votes"]
        sub = windows[:n_check]
        on_dev = batched_consensus(sub, device=dev)
        on_cpu = batched_consensus(sub, device="cpu")
    if on_dev != on_cpu or on_dev != out[:n_check]:
        raise AssertionError("wavefront consensus on the card != CPU plain "
                             "path")
    if n_launch <= 0:
        raise AssertionError("wavefront consensus launched no B4 kernel")
    return {
        "windows": len(windows), "windows_per_s": len(windows) / dt,
        "seconds": dt, "wavefront_votes_launches": n_launch,
        "launches_by_bucket": by_bucket,
        "cpu_plain_equal_windows": n_check,
        "windows_differing_from_rowscan": sum(
            a != b for a, b in zip(out, rowscan_out)
        ),
    }


def phase_oracle(dev, n_reads=4096):
    """The DP-only route (B6 + host ``traceback_batch``) equals the fused
    wavefront mapping (B5) on every row, at two shapes of in-gate reads;
    how many rows the row-scan mapping (B3) differs in is recorded."""
    import numpy as np

    from haslr_tpu_torch.kernels import nw

    rec = {"reads": n_reads}
    for S, W in ((512, 128), (2048, 256)):
        rng = np.random.default_rng(S + 7)
        batch = mutated_batch(rng, n_reads, S, pad_rows=0, gate_w=W)
        r_lens, d_lens = batch[1], batch[3]
        t0 = time.time()
        with nw_engine("wavefront"):
            m_b5 = nw.align_mapping_device(*batch, W, device=dev)
            dirs, base = nw.banded_nw_batch(*batch, W, device=dev)
        m_b6 = nw.traceback_batch(dirs, base, r_lens, d_lens, S)
        del dirs
        with nw_engine("rowscan"):
            m_b3 = nw.align_mapping_device(*batch, W, device=dev)
        if not np.array_equal(m_b6, m_b5):
            raise AssertionError(f"S={S}: banded_nw_batch + traceback_batch"
                                 " != align_mapping_device (wavefront)")
        rec[f"S{S}_W{W}"] = {
            "b6_traceback_rows_equal_b5": n_reads,
            "b3_rows_differing_from_b5": int((m_b3 != m_b5).any(1).sum()),
            "seconds": time.time() - t0,
        }
    return rec


def build_dataset(data_dir, genome_len, seed=7):
    """The 4.6 Mb end-to-end dataset (``scripts/bench_e2e.py``'s
    parameters: 30 repeat families x 8 copies, 40x SR, 15x LR at 6 %),
    simulated once and cached in ``data_dir``."""
    import numpy as np

    from haslr_tpu_torch.testutil import simulate

    g_path = f"{data_dir}/genome.txt"
    sr_path = f"{data_dir}/sr.fq"
    lr_path = f"{data_dir}/lr.fa"
    if all(os.path.isfile(p) for p in (g_path, sr_path, lr_path)):
        return g_path, sr_path, lr_path
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = simulate.genome_with_repeats(
        rng, genome_len, n_families=max(2, genome_len // 153_000),
        copies_per_family=8, repeat_len=400,
    )
    srs = simulate.make_short_reads(rng, genome, coverage=40.0)
    simulate.write_short_reads(sr_path, srs)
    del srs
    lrs = simulate.make_reads(rng, genome, coverage=15.0, mean_len=9000,
                              error_rate=0.06)
    with open(lr_path, "w") as fp:
        for r in lrs:
            fp.write(f">sim{r.rid}\n{r.seq}\n")
    with open(g_path + ".tmp", "w") as fp:
        fp.write(genome)
    os.replace(g_path + ".tmp", g_path)
    return g_path, sr_path, lr_path


def canonical_kmers(seq, k=31):
    """Sorted unique canonical k-mers of an ACGT string, 2 bits a base."""
    import numpy as np

    from haslr_tpu_torch.core import seq as cseq

    c = cseq.encode(seq).astype(np.uint64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    rc = (3 - c)[::-1]
    fw = np.zeros(n, np.uint64)
    bw = np.zeros(n, np.uint64)
    for i in range(k):
        fw = (fw << np.uint64(2)) | c[i : i + n]
        bw = (bw << np.uint64(2)) | rc[i : i + n]
    return np.unique(np.minimum(fw, bw[::-1]))


def _data_paths(scale):
    t0 = time.time()
    paths = build_dataset(
        os.path.join(tempfile.gettempdir(), "haslr_smoke_data", str(scale)),
        scale,
    )
    return paths, time.time() - t0


def _run_cli(dev, scale, threads, out, log_path):
    """The pipeline CLI on ``out``; returns its record (stage times,
    contigs, NG50, recall, the launches of that run)."""
    from haslr_tpu_torch.aligner import map as amap
    from haslr_tpu_torch.cli import haslr as cli

    (g_path, sr_path, lr_path), _ = _data_paths(scale)
    argv = ["-o", out, "-g", str(scale), "-l", lr_path, "-x", "pacbio",
            "-s", sr_path, "-t", str(threads), "--device", dev.type]
    reset_launches()
    t0 = time.time()
    with launch_log() as by_bucket, open(log_path, "w") as log, \
            contextlib.redirect_stdout(log):
        rc = cli.main(argv)
        wall = time.time() - t0
        counts = launches()
    if rc != 0:
        raise AssertionError(f"pipeline exit code {rc}")
    return {
        "launches_by_bucket": by_bucket,
        "scale_bp": scale, "threads": threads, "wall_s": wall,
        "stages_s": dict(cli.STAGE_TIMES), "align_phases_s": dict(amap.PROF),
        **assembly_stats(final_fasta(out), g_path), "launches": counts,
    }


def final_fasta(out):
    final = [f for f in os.listdir(out) if f.startswith("asm_")
             and os.path.isdir(os.path.join(out, f))][0]
    return os.path.join(out, final, "asm.final.fa")


def assembly_stats(fasta, g_path):
    """Contigs, total length, NG50 and interior 31-mer recall."""
    import numpy as np

    from haslr_tpu_torch.core import io as cio

    recs = list(cio.read_fastx(fasta))
    lens = sorted((len(r.seq) for r in recs), reverse=True)
    with open(g_path) as f:
        genome = f.read().strip()
    acc, ng50 = 0, 0
    for L in lens:
        acc += L
        if acc >= len(genome) / 2:
            ng50 = L
            break
    gk = canonical_kmers(genome[1500:-1500])
    ak = np.unique(np.concatenate(
        [canonical_kmers(r.seq) for r in recs] or [np.zeros(0, np.uint64)]
    ))
    recall = len(np.intersect1d(gk, ak, assume_unique=True)) / len(gk)
    return {"n_contigs": len(recs), "total_bp": int(sum(lens)),
            "ng50": ng50, "kmer31_recall": recall}


def phase_e2e(dev, scale, threads, tmp):
    """The pipeline CLI end to end on the simulated data (made, or read
    from the cache, first)."""
    _paths, sim_s = _data_paths(scale)
    rec = _run_cli(dev, scale, threads, os.path.join(tmp, "e2e"),
                   os.path.join(tmp, "e2e.log"))
    return {"sim_s": sim_s, **rec}


def phase_e2e_wavefront(dev, scale, threads, tmp):
    """The pipeline under the wavefront engine, resumed from phase 6's
    output without its PAF and assembly: the skip-if-exists resume runs
    only the aligner (B5) and the assembler (B4) again."""
    src = os.path.join(tmp, "e2e")
    out = os.path.join(tmp, "e2e_wf")

    def drop(d, names):
        return [n for n in names if d == src
                and (n.endswith(".paf") or n.startswith("asm_"))]

    shutil.copytree(src, out, ignore=drop, copy_function=os.link)
    with nw_engine("wavefront"):
        rec = _run_cli(dev, scale, threads, out,
                       os.path.join(tmp, "e2e_wf.log"))
    with open(final_fasta(src), "rb") as f, \
            open(final_fasta(out), "rb") as g:
        rec["asm_final_fa_identical_to_rowscan"] = f.read() == g.read()
    return rec


def _check_e2e(rec, names, what):
    if rec["n_contigs"] != 1 or rec["kmer31_recall"] < 0.999:
        raise AssertionError(
            f"{what}: {rec['n_contigs']} contigs, recall "
            f"{rec['kmer31_recall']:.5f} (want 1 contig, >= 0.999)"
        )
    for name in names:
        if rec["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} not launched in {what}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    from haslr_tpu_torch.device import resolve_device
    from haslr_tpu_torch.kernels import _build

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _line("1 card", nvidia_smi=smi, torch_device=kind,
          torch=torch.__version__, cuda=torch.version.cuda)

    build_s, log = _build.build_info()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    _line("2 build", seconds=build_s, ptxas=ptxas)

    errs = dict.fromkeys(KERNELS, 0)

    def check(name, err):
        errs[name] = max(errs[name], err)

    t0 = time.time()
    for S, W in ((512, 128), (1024, 128), (2048, 256), (4096, 512)):
        check("rowscan_votes", check_votes(dev, S, W, 64, S))
        check("rowscan_mapping",
              check_plain(dev, "rowscan_mapping", S, W, 64, S + 3))
    for S, W, B in ((256, 128, 64), (1024, 128, 64), (2048, 256, 32),
                    (8192, 512, 16)):
        check("rowscan_cigar", check_cigar(dev, S, W, B, S + 1))
    check("rowscan_cigar",
          check_cigar(dev, 256, 128, 32, 23, maxr=64, overflow=True))
    for S, W, B in ((512, 128, 64), (1024, 128, 64), (2048, 256, 32),
                    (8192, 512, 16)):
        check("wavefront_votes",
              check_votes(dev, S, W, B, S + 4, "wavefront"))
        check("wavefront_mapping",
              check_plain(dev, "wavefront_mapping", S, W, B, S + 5))
    for S in (256, 1024):
        check("wavefront_dirs",
              check_plain(dev, "wavefront_dirs", S, 128, 64, S + 6))
    # every route of the row-scan design, (C, WPR) by W and by B on either
    # side of the small-launch limit; then bands and row widths that run
    # masked or padded
    route_shapes = (
        (512, 512, 128, 64), (1024, 1024, 128, 64), (2048, 2048, 256, 32),
        (1024, 1024, 512, 24), (1024, 1024, 512, 272),
        (4096, 4096, 512, 16), (2048, 2048, 512, 256),
        (16384, 16384, 512, 32),
        (512, 512, 32, 64), (512, 512, 96, 64), (1024, 1024, 160, 32),
        (1024, 1024, 480, 16), (1024, 1024, 320, 260),
        (510, 510, 128, 64), (510, 509, 96, 64), (301, 299, 32, 64),
        (2047, 2045, 256, 32), (1022, 1021, 512, 16),
    )
    t_routes = time.time()
    took = [[R, D, W, B, *check_shape(dev, R, D, W, B, R + 11)]
            for R, D, W, B in route_shapes]
    took.append([256, 256, 128, 32,
                 *check_shape(dev, 256, 256, 128, 32, 23, overflow=True),
                 "MAXR overflow"])
    want = {(4, 1), (8, 1), (16, 1), (4, 4)}
    if {(C, wpr) for _R, _D, _W, _B, C, wpr, *_ in took} != want:
        raise AssertionError(f"phase 3a did not take every route: {took}")
    _line("3a row-scan routes == plain", tolerance=TOL,
          kernels=["rowscan_votes", "rowscan_cigar", "rowscan_mapping"],
          shapes_R_D_W_B_C_WPR=took, max_abs_err=0,
          seconds=time.time() - t_routes)
    times = {S: time_pair(dev, S, 128, 2048, S + 2) for S in (512, 1024)}
    big = time_pair(dev, 16384, 512, 32, 16386, only=("rowscan_cigar",),
                    plain_once=True)
    for name in KERNELS:
        _line("3b time and bound", kernel=name, card=smi,
              **{f"B2048_S{S}_W128": t[name] for S, t in times.items()},
              **({"B32_S16384_W512": big[name]} if name in big else {}))
    _line("3 kernel == plain", tolerance=TOL,
          votes_shapes="S,W = 512,128 1024,128 2048,256 4096,512",
          cigar_shapes="S,W = 256,128 1024,128 2048,256 8192,512 "
                       "+ MAXR overflow",
          rowscan_mapping_shapes="S,W = 512,128 1024,128 2048,256 4096,512",
          wavefront_votes_mapping_shapes="S,W = 512,128 1024,128 2048,256 "
                                         "8192,512",
          wavefront_dirs_shapes="S,W = 256,128 1024,128",
          max_abs_err=errs, seconds=time.time() - t0,
          ms_kernel_plain_B2048={
              f"S{S}_W128": {k: {"kernel_ms": v["ms"],
                                 "plain_ms": v["plain_ms"]}
                             for k, v in t.items()}
              for S, t in times.items()
          })

    path_launches = {}
    with tempfile.TemporaryDirectory(prefix="haslr_smoke_") as tmp:
        golden_s = phase_golden(dev, tmp)
        _line("4 golden", identical=["tpu.asm.final.fa", "tpu.asm.final.ann"],
              seconds=golden_s)

        windows = make_windows(n_windows=4096)
        cons, rowscan_out = phase_consensus(dev, windows)
        _line("5 consensus", device=kind, **cons)

        threads = os.cpu_count() or 1
        rec = phase_e2e(dev, E2E_SCALE, threads, tmp)
        _line("6 end to end", device=kind, **rec)
        _check_e2e(rec, ("rowscan_votes", "rowscan_cigar"), "end to end")
        path_launches["e2e"] = rec["launches"]

        reset_launches()
        oracle = phase_oracle(dev)
        path_launches["oracle"] = launches()
        _line("7 oracle", device=kind, **oracle,
              launches=path_launches["oracle"])
        for name in ("rowscan_mapping", "wavefront_mapping",
                     "wavefront_dirs"):
            if path_launches["oracle"][name] <= 0:
                raise AssertionError(f"kernel {name} not launched in the "
                                     "oracle phase")

        with nw_engine("wavefront"):
            reset_launches()
            golden_s = phase_golden(dev, tmp, "golden_asm_wf")
            n_b4 = launches()["wavefront_votes"]
        if n_b4 <= 0:
            raise AssertionError("wavefront golden run launched no B4")
        _line("8 golden, wavefront",
              identical=["tpu.asm.final.fa", "tpu.asm.final.ann"],
              seconds=golden_s, wavefront_votes_launches=n_b4)

        _line("9 consensus, wavefront", device=kind,
              **phase_consensus_wavefront(dev, windows, rowscan_out))

        rec_wf = phase_e2e_wavefront(dev, E2E_SCALE, threads, tmp)
        _line("10 end to end, wavefront", device=kind, **rec_wf)
        _check_e2e(rec_wf, ("wavefront_votes", "wavefront_mapping"),
                   "end to end under the wavefront engine")
        path_launches["e2e_wf"] = rec_wf["launches"]

    return [
        json.dumps({"kernels": [
            {"name": name, "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": path_launches[path][name],
             "max_abs_err": errs[name],
             "ms": times[512][name]["ms"],
             "plain_ms": times[512][name]["plain_ms"],
             "bound_ms": times[512][name]["bound_ms"],
             "bound_by": times[512][name]["bound_by"], "library_ms": None}
            for name, (src, replaces, path) in KERNELS.items()
        ]}),
        smi,
        json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count(),
        }}),
    ]


def child_pids():
    """The live processes whose parent is this one (zombies left out)."""
    me, out = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except OSError:
            continue  # gone between the listing and the read
        if ppid == me and state != "Z":
            out.append(int(pid))
    return out


def stop_children():
    """End every process this run started and return those that had to
    be killed.  The pipeline's seeding pool (spawn context) ends its
    workers itself but leaves Python's multiprocessing resource tracker
    running until the interpreter exits and a moment beyond; it is
    stopped here, once the pool's semaphores are collected, so that
    nothing outlives the script."""
    import gc
    import signal
    from multiprocessing import resource_tracker

    gc.collect()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    left = child_pids()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except OSError:
            pass
    return left


if __name__ == "__main__":
    try:
        last_lines = main()
    finally:
        killed = stop_children()
    if killed:
        raise SystemExit(f"chip_smoke: processes still running at the end, "
                         f"killed: {killed}")
    print("\n".join(last_lines))
