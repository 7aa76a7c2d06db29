"""Smoke run of the PyTorch/CUDA port (haslr_tpu_torch) on one NVIDIA GPU.

Phases, one printed line each (any failure raises):

1. the card (``nvidia-smi`` name and power limit) and the torch device;
2. build of the CUDA kernels from ``haslr_tpu_torch/csrc`` (one nvcc per
   source, in parallel, sm_90a);
3. each of the six NW kernels against its plain PyTorch version on the
   card, exact: the two vote-plane kernels down to the vote tables (V1 on
   the kernel's planes, the plain tables on the plain planes) at the
   consensus buckets' shapes; the three row-scan kernels at every
   route of their design (lanes a thread, warps a read: W = 128, 256,
   and 512 at launches on either side of the small-launch limit;
   ragged, empty, out-of-gate and pad rows, the MAXR-overflow batch, and
   the CIGAR-run kernel at S=16384/W=512 on 32 reads) and at bands and
   row widths off the main path (W = 32 to 480, R and D no multiples of
   four); the three wavefront kernels likewise at every route of theirs,
   at masked bands, at R != D and at odd row widths, and the mapping
   kernel at S=16384/W=512; then each kernel's time (CUDA events) beside
   its plain version's and its bound on this card;
4. the golden assembly (``tests/golden``) through the CUDA consensus,
   byte for byte;
5. the consensus workload (4096 windows x 13 reads x ~300 bp at 6 %
   error): windows/s on the card beside the native POA on one CPU core,
   the card's output equal to the CPU plain path's on 256 windows, the
   dense engine's host ``PROF``, and V1 launched once a round and shard;
5b. the vote-tables kernel V1 against its plain version, exact: on
   synthetic rounds at every bucket S = 128-65536 (code-4 cells, rows
   out of the gate or unaligned, empty windows, the inert pad read; a
   full 65,536-read dispatch at S = 4096, and its tables summed over a
   two-block split cut inside a window; a synthetic round of the
   consensus workload's shape), each timed; on rounds at the edges of
   V1's design (one window holding every row, deeper than the 8-bit
   counters and the ring, at S = 512 and at the column-tiled S = 4096,
   and that round split in two inside the window; deep windows among
   empty ones at S = 512 and 8192; N no multiple of the persistent
   grid), and on the consensus workload's real planes of both rounds
   under both NW engines; V1's launch plan by bucket (tile, rows a
   stage, grid, CTAs an SM, shared memory) and ptxas's report; then at
   that workload's round (N = 4096, B = 53,248, S = 512) V1's and one
   ``torch.matmul``'s (the reference's segment-matrix product in bf16)
   ms a launch (the median of 5 windows of 50 launches queued back to
   back behind a spin that holds the card until they are queued; 10 for
   the matmul), V1's median ms of 5 single calls (the
   host's time to the launch included) and its host µs a call, the
   plain version's median ms, the byte bound, and the peak device
   memory of V1 and the plain version;
6. the five-stage pipeline (``haslr_tpu_torch.cli.haslr``) end to end on
   a simulated 4.6 Mb genome: stage times, contigs, NG50, interior 31-mer
   recall, the kernel launch counts of that run, and the CIGAR-run
   kernel's launches by bucket (S, W, launches, reads, device ms);

then the same paths under the wavefront engine (``nw.ENGINE =
"wavefront"``, restored after each phase):

7. the oracle: ``nw.banded_nw_batch`` + ``traceback_batch`` equal to
   ``nw.align_mapping_device`` (wavefront) on 4096 in-gate reads at two
   shapes, and how many rows the row-scan engine's mapping (B3) differs
   in; B3, B5 and B6 each launched there;
8. the golden assembly again, byte for byte;
9. the consensus workload: windows/s, the card equal to the CPU plain
   path on 256 windows, how many windows differ from phase 5's, and V1
   once a round;
10. the 4.6 Mb pipeline resumed from phase 6's output without its PAF and
    assembly, so that the aligner and the assembler run again: stage
    times, contigs, NG50, recall, launches, and whether ``asm.final.fa``
    equals phase 6's;

then, under the row-scan engine again, on a ``dp`` mesh of two shards
(``make_mesh(2)`` where two cards are visible, else
``Mesh(["cuda:0", "cuda:0"])``: one card split in two, which proves the
split and the summed tables exact with the kernels on the card, and
neither a launch on a second card nor a speed-up):

11. the consensus workload through the mesh, equal to phase 5's output on
    all 4096 windows (windows/s, B1's launches); the 4.6 Mb pipeline
    through ``run_pipeline(..., mesh=...)`` into a new directory, its SR
    contigs and ``asm.final.fa`` equal to phase 6's (stage times,
    launches by kernel and bucket); two processes under gloo, both on
    ``cuda:0``, mapping host shards of a simulated 200 kb genome, their
    PAF lines equal to one process's; and the standalone
    ``haslr_assemble`` on the golden inputs, equal to phase 4's bytes;
    and the consensus workload under the wavefront engine through the
    mesh, equal to phase 9's output on all 4096 windows (B4 a shard);
    V1 once a round and shard in 11a and 11e;

then the modules that hold no kernel of their own:

12. the device k-mer counters on phase 6's short reads (40x of 4.6 Mb,
    k = 49, abundance 3): ``count_kmers_device`` on the whole
    concatenated stream and ``count_kmers_streaming`` at its defaults,
    each equal to the native counter array for array (seconds and
    Mbases/s of all three, the streaming ``PROF``, the peak device
    memory), and the SR stage through ``assemble_short_reads(
    streaming=True)`` writing phase 6's SR contigs byte for byte;
12b. the streaming counter's sharded phase-2 merge over phase 11's mesh
    and its disk spill, on 11c's long reads, each equal to the native
    count.

The bound of a kernel is the larger of its bytes (inputs read once,
outputs written once) over 3.35 TB/s and its int32 operations on this
run's inputs over 132 SMs x 64 lanes x 1.98 GHz (``kernel_bound``; V1:
``vote_tables_bound``).

Then a JSON line of kernel records, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Needs one CUDA
device, the CUDA toolkit (nvcc) and g++; exits non-zero without them.

Usage: python3 chip_smoke.py

``python3 chip_smoke.py --v1 [ROOT]`` runs only phase 5b's synthetic
rounds, held equal to the plain version and timed, with the
``haslr_tpu_torch`` package found in ROOT (this checkout by default), so
that two versions of V1 can be timed in turns on one card; it prints one
JSON line.
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
import warnings

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
    # V1: the reference's XLA reduction, no Pallas kernel there
    "vote_tables": ("haslr_tpu_torch/csrc/vote_tables.cu",
                    "haslr_tpu/kernels/consensus_dense.py:401", "e2e"),
}


# the least time the card could take: HBM3 bytes/s, and int32 add / max /
# compare issued on 64 lanes an SM (half the 33.5 T instructions/s behind
# the published 67 TFLOP/s of float32)
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 132 * 64 * 1.98e9
# int32 operations a DP cell that the function needs.  Row-scan: the
# substitution score (compare, select), two candidate adds, their max, the
# valid mask (compare, select), the -gap*k shift, the scan max, the +gap*k
# shift, the direction (two compares, two selects).  Wavefront directions
# (every cell of the tensor must be the reference's, so every gate
# counts): the score (2), three candidate adds, their three gates (i >= 1,
# j >= 1: two compares, three selects), two maxes, the direction (4), the
# valid mask (compare, select).  Wavefront mapping and votes: only cells
# the walk can reach count, which need no gate and no upper mask, and a
# tag in the candidates' low bits makes the maximum carry the direction:
# the score (2), three adds, two maxes, the tag cleared.
OPS_PER_CELL = {"rowscan": 14, "wavefront_dirs": 18, "wavefront": 8}


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
    ops = OPS_PER_CELL.get(name, OPS_PER_CELL[engine])
    ops_ms = rows * W * ops / PEAK_INT32_S * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def vote_tables_bound(B, N, S):
    """``(bound_ms, bound_by)`` of V1 on one round: each plane byte of
    the 3S+2 used columns, the stats, the ok bytes and the CSR offsets
    read once, the tables written once; an int32 add a plane byte."""
    in_bytes = B * (3 * S + 2) + B * 8 + B + (N + 1) * 4
    out_bytes = N * (3 * S + 2) * 16 + (N * (S + 1) + 1) * 4 + N * 4
    ops_ms = B * (3 * S + 2) / PEAK_INT32_S * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")


def _counters():
    from haslr_tpu_torch.kernels import nw_rowscan, nw_wavefront, vote_tables

    return nw_rowscan.LAUNCHES, nw_wavefront.LAUNCHES, vote_tables.LAUNCHES


def reset_launches():
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def launches():
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


LOG_ROOT = "chip_smoke.launch_log"


@contextlib.contextmanager
def launch_log():
    """Every kernel launch of the block, from the port's trace (the block
    runs under ``trace.recording()`` in a root span named
    :data:`LOG_ROOT`): yields a list that holds, once the block has
    ended, one record a (kernel, S, W) bucket: launches, reads and device
    ms."""
    import torch

    from haslr_tpu_torch import trace

    out = []
    with trace.recording(), trace.span(LOG_ROOT) as root:
        yield out
    torch.cuda.synchronize()
    buckets = {}
    for x in trace.launches_of(root):
        S = x.S or x.width  # V1's width, else the rows' width
        b = buckets.setdefault((x.kernel, S, x.band), {
            "kernel": x.kernel, "S": S, "W": x.band, "launches": 0,
            "reads": 0, "device_ms": 0.0})
        b["launches"] += 1
        b["reads"] += x.rows
        b["device_ms"] += trace.device_ms(x)
    out.extend(buckets[k] for k in sorted(buckets))


def stage_seconds():
    """Seconds of each ``pipeline.<stage>`` span of the last
    :func:`launch_log` block."""
    from haslr_tpu_torch import trace

    root = trace.roots(LOG_ROOT)[-1]
    return {s.name.split(".", 1)[1]: (s.end_ns - s.start_ns) * 1e-9
            for s in trace.spans_of(root)
            if s.name.startswith("pipeline.") and s.name != "pipeline.run"}


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


def check_shape(dev, R, D, W, B, seed, overflow=False, only=None):
    """B1, B2 and B3 (or those in ``only``) on the card at one shape
    against their plain versions, every row and every slot, exact;
    returns the largest difference (0, or it raises) and the (C, WPR)
    route the wrappers took."""
    import numpy as np

    from haslr_tpu_torch.kernels import nw_rowscan as rs

    rng = np.random.default_rng(seed)
    reads, r_lens, drafts, d_lens = overflow_batch(rng, B, D) if overflow \
        else mutated_batch(rng, B, D)
    reads = np.pad(reads, ((0, 0), (0, R - D)), constant_values=4)
    r_lens[2] = R + 1  # longer than its row: a full DP and no walk
    args = _to(dev, reads, r_lens, drafts, d_lens)
    maxr = 64 if overflow else max(128, R // 4)
    what = f"R={R} D={D} W={W} B={B}"
    pairs = []
    if only is None or "rowscan_cigar" in only:
        runs_p, n_p = rs.rowscan_cigar_plain(*args, W, 2, -4, -2, maxr)
        if overflow and not bool((n_p > maxr).any()):
            raise AssertionError("overflow batch did not overflow MAXR")
        runs_k, n_k = rs.rowscan_cigar(*args, W, 2, -4, -2, maxr)
        pairs += [(f"n_runs {what}", n_k, n_p),
                  (f"runs {what}", runs_k, runs_p)]
    if only is None or "rowscan_votes" in only:
        planes_p, stats_p = rs.rowscan_votes_plain(*args, W, 5, -4, -8)
        planes_k, stats_k = rs.rowscan_votes(*args, W, 5, -4, -8)
        pairs += [(f"planes {what}", planes_k, planes_p),
                  (f"stats {what}", stats_k, stats_p)]
    if only is None or "rowscan_mapping" in only:
        pairs.append((f"mapping {what}",
                      rs.rowscan_mapping(*args, W, 5, -4, -8),
                      rs.rowscan_mapping_plain(*args, W, 5, -4, -8)))
    return (_max_err(pairs), *rs._route(W, B, rs._sm_count(dev))[:2])


def check_wavefront_shape(dev, R, D, W, B, seed, only=None):
    """B4, B5 and B6 (or those in ``only``) on the card at one shape
    against their plain versions: planes, stats and mapping on every row,
    B6 on every cell, exact; returns the largest difference (0, or it
    raises) and the (C, WPR) route the wrappers took."""
    import numpy as np

    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf

    rng = np.random.default_rng(seed)
    reads, r_lens, drafts, d_lens = mutated_batch(rng, B, min(R, D))
    reads = np.pad(reads, ((0, 0), (0, R - reads.shape[1])),
                   constant_values=4)
    drafts = np.pad(drafts, ((0, 0), (0, D - drafts.shape[1])),
                    constant_values=4)
    args = _to(dev, reads, r_lens, drafts, d_lens)
    what = f"R={R} D={D} W={W} B={B}"
    pairs = []
    if only is None or "wavefront_votes" in only:
        planes_k, stats_k = wf.wavefront_votes(*args, W, 5, -4, -8)
        planes_p, stats_p = wf.wavefront_votes_plain(*args, W, 5, -4, -8)
        pairs += [(f"planes {what}", planes_k, planes_p),
                  (f"stats {what}", stats_k, stats_p)]
    if only is None or "wavefront_mapping" in only:
        pairs.append((f"mapping {what}",
                      wf.wavefront_mapping(*args, W, 2, -4, -2),
                      wf.wavefront_mapping_plain(*args, W, 2, -4, -2)))
    if only is None or "wavefront_dirs" in only:
        pairs.append((f"dirs {what}",
                      wf.wavefront_dirs(*args, W, 5, -4, -8),
                      wf.wavefront_dirs_plain(*args, W, 5, -4, -8)))
    return (_max_err(pairs), *wf._route(W, B, rs._sm_count(dev))[:2])


def check_votes(dev, S, W, B, seed, engine="rowscan"):
    """B1 (``engine="rowscan"``) or B4 (``"wavefront"``) on the card vs
    its plain version: planes, stats and the vote tables (V1 on the
    kernel's planes, the plain tables on the plain planes), every row (in
    and out of the gate, pad rows)."""
    import numpy as np
    import torch

    from haslr_tpu_torch.kernels import nw_rowscan as rs
    from haslr_tpu_torch.kernels import nw_wavefront as wf
    from haslr_tpu_torch.kernels import vote_tables as vt

    kern, plain = {
        "rowscan": (rs.rowscan_votes, rs.rowscan_votes_plain),
        "wavefront": (wf.wavefront_votes, wf.wavefront_votes_plain),
    }[engine]
    rng = np.random.default_rng(seed)
    args = _to(dev, *mutated_batch(rng, B, S))
    planes_k, stats_k = kern(*args, W, 5, -4, -8)
    planes_p, stats_p = plain(*args, W, 5, -4, -8)
    N = 8
    win_np = np.sort(rng.integers(0, N, B))
    win = torch.from_numpy(win_np).to(dev)
    win_ptr = torch.from_numpy(vt.window_rows(win_np, N)).to(dev)
    r_lens, d_lens = args[1], args[3]
    ok = (r_lens > 0) & (d_lens > 0) & ((r_lens - d_lens).abs() < W // 2 - 4)
    tabs_k = vt.vote_tables(planes_k, stats_k, win_ptr, ok, N, S)
    tabs_p = vt.vote_tables_plain(planes_p, stats_p, win, ok, N, S)
    names = ("counts", "cov_diff", "ins1", "ins2", "n_reads")
    return _max_err(
        [("planes", planes_k, planes_p), ("stats", stats_k, stats_p)]
        + [(n, a, b) for n, a, b in zip(names, tabs_k, tabs_p)]
    )


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


def time_pair(dev, S, W, B, seed, only=None, with_plain=True):
    """Per kernel (all six, or those in ``only``) at one shape: kernel ms
    (CUDA events around 5 warm launches, best of two turns) and plain ms
    (one warm call; ``with_plain=False`` leaves it out, for shapes where
    it takes tens of seconds), the bound on this batch and the share of
    it reached."""
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
        plain_ms = ms(lambda: plain(*args, W, *extra), 1) if with_plain \
            else "not timed"
        k1 = ms(lambda: kern(*args, W, *extra), 5)
        k2 = ms(lambda: kern(*args, W, *extra), 5)
        res = kern(*args, W, *extra)
        res = res if isinstance(res, tuple) else (res,)
        bound_ms, bound_by = kernel_bound(
            name, args[1], args[3], S, S, W,
            sum(a.numel() * a.element_size() for a in args),
            sum(o.numel() * o.element_size() for o in res),
        )
        del res
        out[name] = {
            "ms": min(k1, k2), "plain_ms": plain_ms,
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


def check_v1_launches(prof, shards, what, rounds=2):
    """V1's launches since the last reset, which must be one a round and
    shard of every dispatch in ``prof`` (the dense engine's ``PROF``):
    no round's tables came from anywhere else."""
    n_v1 = launches()["vote_tables"]
    want = rounds * int(prof.get("n_dispatch", 0)) * shards
    if n_v1 != want or not want:
        raise AssertionError(f"{what}: V1 launched {n_v1} times, want "
                             f"{rounds} rounds x {prof.get('n_dispatch')} "
                             f"dispatches x {shards} shards")
    return n_v1


def phase_consensus(dev, windows, n_check=256, n_poa=512):
    """Windows/s of the port's consensus on ``dev`` and of the native POA
    on one core; the card's output equals the CPU plain path's on
    ``n_check`` windows.  Returns (record, the card's consensus)."""
    import torch

    from haslr_tpu_torch import native
    from haslr_tpu_torch.core import seq as cseq
    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    code_wins = [[cseq.encode(s) for s in w] for w in windows[:n_poa]]
    native.poa_consensus_native(code_wins[:2])  # build / load the library
    t0 = time.time()
    native.poa_consensus_native(code_wins, n_threads=1)
    poa_rate = len(code_wins) / (time.time() - t0)

    batched_consensus(windows[:64], device=dev)  # first-call warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    cd.PROF.clear()
    with launch_log() as by_bucket:
        t0 = time.time()
        out = batched_consensus(windows, device=dev)
        dt = time.time() - t0
    prof = dict(cd.PROF)
    n_v1 = check_v1_launches(prof, 1, "phase 5")
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
        "vote_tables_launches": n_v1, "prof_s": prof,
        "poa_1core_windows_per_s": poa_rate,
        "poa_windows": len(code_wins), "cpu_plain_equal_windows": n_check,
    }, out


# phase 5b's synthetic rounds, (rows B, windows N) by bucket S: at
# S = 4096 a full dispatch of the dense engine (MAX_READS rows, 13 a
# window), above it fewer rows as the planes widen
V1_ROUNDS = {
    **{S: (2048, 256) for S in (128, 256, 512, 1024, 2048)},
    4096: (65536, 5041), 8192: (512, 64), 16384: (256, 32),
    32768: (128, 16), 65536: (64, 8),
}


# phase 5b's rounds at the edges of V1's design, (S, rows of each
# window): one window holding every row, deeper than the 8-bit counters
# (255 rows) and than the ring (2 stages of 16 rows), at a whole-window
# tile (S = 512) and a column-tiled bucket (S = 4096, 8 tiles); deep
# windows among empty ones and windows cut at the chunks' edges (1, 16,
# 17, 32, 33 rows)
V1_EDGE_ROUNDS = {
    "one_deep_window_S512": (512, [0, 0, 0, 700, 0, 0, 0]),
    "one_deep_window_S4096": (4096, [0, 0, 300, 0, 0]),
    "deep_among_empty_S512": (512, [0, 257, 0, 0, 1, 16, 17, 0, 1000, 32,
                                    33, 0, 0, 513, 0, 0]),
    "deep_among_empty_S8192": (8192, [0, 300, 0, 17, 0, 0, 33, 0]),
}


def synthetic_round(dev, S, B, N, seed, sizes=None):
    """One round's votes-kernel outputs made on the card from ``seed``,
    rows sorted by window: planes of codes 0-4 (half of them 4), stats
    with jmin <= jmax < S (a tenth unaligned: jmax = -1), ok (a tenth out
    of the gate), only the even windows holding rows, and the last row
    the dispatch's inert pad read (window N - 1, not ok, all code 4).
    With ``sizes`` (rows of each of the N windows; B their sum) the rows
    fall into the windows so, and there is no pad read.  Returns (planes,
    stats, win, ok) on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device=dev)

    planes = torch.randint(0, 4, (B, 3 * S + 256), generator=g, device=dev,
                           dtype=torch.uint8)
    planes[rand(B, 3 * S + 256) < 0.5] = 4
    jmin = ints(S, B)
    jmax = torch.minimum(jmin + ints(S, B), torch.tensor(S - 1, device=dev))
    none = rand(B) < 0.1
    jmin[none], jmax[none] = 1 << 29, -1
    ok = rand(B) >= 0.1
    if sizes is not None:
        win = torch.repeat_interleave(
            torch.arange(N, device=dev), torch.tensor(sizes, device=dev))
    else:
        win = (2 * ints((N + 1) // 2, B)).sort().values
        planes[-1], jmin[-1], jmax[-1], ok[-1], win[-1] = 4, 1 << 29, -1, \
            False, N - 1
    stats = torch.stack([jmin, jmax], 1).to(torch.int32)
    return planes, stats, win, ok


def ptxas_of(kernel):
    """ptxas's report (registers, shared memory, spills) of the kernels
    whose mangled name holds ``kernel``, from the build's log."""
    from haslr_tpu_torch.kernels import _build

    out, take = [], False
    for ln in _build.build_info()[1].splitlines():
        if "Compiling entry function" in ln:
            take = kernel in ln
        elif take and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


def _v1_vs_plain(planes, stats, win, win_ptr, ok, N, S, what):
    """V1 == plain on one round, every table, exact; returns V1's
    tables."""
    from haslr_tpu_torch.kernels import vote_tables as vt

    got = vt.vote_tables(planes, stats, win_ptr, ok, N, S)
    want = vt.vote_tables_plain(planes, stats, win, ok, N, S)
    names = ("counts", "cov_diff", "ins1", "ins2", "n_reads")
    _max_err([(f"{n} {what}", a, b) for n, a, b in zip(names, got, want)])
    return got


def profile_consensus(dev, windows, top=10):
    """One dense consensus call of ``windows`` (row-scan engine) under
    ``torch.profiler``: the device time of its kernels and copies in all
    and by name (the ``top`` largest), the call's wall time and the
    device's idle share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from haslr_tpu_torch.kernels.consensus import batched_consensus

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # one profiling cycle: its note that events clear at a cycle's end
        warnings.filterwarnings("ignore", message=".*clears events")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            batched_consensus(windows, device=dev)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    items = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue  # host ops; their kernels are listed on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        items.append([e.key[:80], us / 1e3, e.count])
    items.sort(key=lambda it: -it[1])
    device_ms = sum(it[1] for it in items)
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if items else "not measured",
            "device_idle_share": 1 - device_ms / wall_ms if items
            else "not measured",
            "by_kernel_ms_count": items[:top]}


def rows_of(win, N):
    """``window_rows`` of the windows ``win`` (a tensor), on its device."""
    import torch

    from haslr_tpu_torch.kernels import vote_tables as vt

    return torch.from_numpy(vt.window_rows(win.cpu().numpy(), N)).to(
        win.device)


def v1_launch_ms(fn, n=50, turns=5, hold_cycles=20_000_000):
    """V1's (or another call's) ms a launch on the card: ``turns``
    windows of ``n`` warm calls queued back to back between two CUDA
    events, the median window's ms over ``n``; returns (ms, every
    window's).  Each window waits on the card behind a spin of
    ``hold_cycles`` clocks (~10 ms), so that the host has queued its
    calls before the first starts and a call faster than the host's
    time to launch it is timed as the card runs it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(turns):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return sorted(times)[turns // 2], times


def one_call_ms(fn, n_med=5):
    """One call's ms between two CUDA events on an idle card, median of
    ``n_med`` warm calls: the host's time to the launch counts."""
    import torch

    fn()
    times = []
    for _ in range(n_med):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n_med // 2]


def host_us(fn, n=50):
    """The host's µs a call while the card is kept busy: ``n`` calls
    queued back to back, timed on the host's clock up to the last
    launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def v1_rounds(dev):
    """V1 == its plain version on the synthetic rounds at every bucket
    (``V1_ROUNDS``; at S = 4096 also its tables summed over a two-block
    split cut inside a window) and on a synthetic round of the consensus
    workload's shape (4096 windows of 13 rows, S = 512), each timed
    (:func:`v1_launch_ms`) beside ``vote_tables_bound``.  Uses only the
    wrapper's ``vote_tables``, ``vote_tables_plain`` and ``window_rows``.
    """
    import numpy as np
    import torch

    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels import vote_tables as vt

    rec = {"tolerance": TOL, "buckets_S_B_N": [], "ms_by_S": {}}
    rounds = [(S, *V1_ROUNDS[S], None, f"S={S}") for S in cd.BUCKETS]
    rounds.append((512, 13 * 4096, 4096, [13] * 4096, "consensus_shape"))
    for S, B, N, sizes, name in rounds:
        planes, stats, win, ok = synthetic_round(dev, S, B, N, S, sizes)
        win_ptr = rows_of(win, N)
        whole = _v1_vs_plain(planes, stats, win, win_ptr, ok, N, S, name)
        ms, turns = v1_launch_ms(
            lambda: vt.vote_tables(planes, stats, win_ptr, ok, N, S))
        bound_ms = vote_tables_bound(B, N, S)[0]
        if sizes is None:
            rec["buckets_S_B_N"].append([S, B, N])
        rec["ms_by_S"][name] = {"N": N, "B": B, "ms": ms, "ms_turns": turns,
                                "bound_ms": bound_ms,
                                "share_of_bound": bound_ms / ms}
        if S == 4096:  # two blocks, the cut one row into a window
            ptr = vt.window_rows(win.cpu().numpy(), N)
            w = int(np.searchsorted(ptr, B // 2, "right")) - 1
            while ptr[w + 1] - ptr[w] < 2:
                w += 1
            at = int(ptr[w]) + 1
            parts = [_v1_vs_plain(planes[lo:hi], stats[lo:hi], win[lo:hi],
                                  rows_of(win[lo:hi], N), ok[lo:hi], N, S,
                                  f"S={S} rows {lo}:{hi}")
                     for lo, hi in ((0, at), (at, B))]
            _max_err([(f"split at row {at} (window {w})", a + b, c)
                      for a, b, c in zip(*parts, whole)])
            rec["split_at_row"] = [at, B, f"window {w}: rows "
                                   f"{int(ptr[w])}:{int(ptr[w + 1])}"]
        del planes, stats, win, ok, whole
        torch.cuda.empty_cache()
    return rec


def phase_vote_tables(dev, windows, n_med=5):
    """Phase 5b: :func:`v1_rounds` (every bucket, timed); V1 == its plain
    version on the design's edge rounds (``V1_EDGE_ROUNDS``, a deep
    window's split, N no multiple of the grid) and on the consensus
    workload's real planes of both rounds under both NW engines; then at
    that workload's first round V1's and the ``torch.matmul``
    yardstick's ms a launch (:func:`v1_launch_ms`), V1's and the plain
    version's median ms of ``n_med`` single calls (:func:`one_call_ms`),
    the host's µs a V1 call, the bound, the launch plan by bucket,
    ptxas's report and the peak memory."""
    import numpy as np
    import torch

    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels import vote_tables as vt
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    t_start = time.time()
    rec = v1_rounds(dev)
    rec["plan_by_S"] = {S: vt.launch_plan(V1_ROUNDS[S][1], S, dev)
                        for S in cd.BUCKETS}

    # the design's edges: deep windows (one holding every row, then a
    # two-block split cut inside it), empty ones among them, and N not a
    # multiple of the persistent grid
    grid = vt.launch_plan(1 << 20, 512, dev)["grid"]
    rng = np.random.default_rng(5)
    edges = {**V1_EDGE_ROUNDS, "n_off_grid_S512": (
        512, rng.integers(0, 30, 3 * grid + 7).tolist())}
    rec["edge_rounds_S_B_N"] = {}
    for i, (name, (S, sizes)) in enumerate(edges.items()):
        B, N = sum(sizes), len(sizes)
        planes, stats, win, ok = synthetic_round(dev, S, B, N, 100 + i,
                                                 sizes)
        whole = _v1_vs_plain(planes, stats, win, rows_of(win, N), ok, N, S,
                             name)
        rec["edge_rounds_S_B_N"][name] = [S, B, N]
        if name == "one_deep_window_S4096":
            at = B // 2
            parts = [_v1_vs_plain(planes[lo:hi], stats[lo:hi], win[lo:hi],
                                  rows_of(win[lo:hi], N), ok[lo:hi], N, S,
                                  f"{name} rows {lo}:{hi}")
                     for lo, hi in ((0, at), (at, B))]
            _max_err([(f"{name} split at row {at}", a + b, c)
                      for a, b, c in zip(*parts, whole)])
            rec["edge_split_at_row"] = [name, at, B]
        del planes, stats, win, ok, whole
    rec["n_off_grid"] = {"grid": grid, "N": len(edges["n_off_grid_S512"][1])}

    # the workload's real rounds: every call of the dense engine's
    # tables checked, the first row-scan round kept for the timing
    rounds, kept = [], []
    real = cd.vote_tables

    def checked(planes, stats, win_ptr, ok, N, S):
        win = torch.repeat_interleave(
            torch.arange(N, device=dev), win_ptr.diff().to(torch.int64))
        got = _v1_vs_plain(planes, stats, win, win_ptr, ok, N, S,
                           f"real round {len(rounds)}")
        rounds.append([S, planes.shape[0], N])
        if not kept:
            kept.append((planes, stats, win, win_ptr, ok, N, S))
        return got

    cd.vote_tables = checked
    try:
        for engine in ("rowscan", "wavefront"):
            with nw_engine(engine):
                batched_consensus(windows, device=dev)
    finally:
        cd.vote_tables = real
    rec["real_rounds_S_B_N"] = rounds
    if len(rounds) < 4:
        raise AssertionError(f"phase 5b saw {len(rounds)} real rounds")

    planes, stats, win, win_ptr, ok, N, S = kept[0]
    B = planes.shape[0]
    off1, off2 = vt.plane_offsets(S)
    cols = torch.cat([planes[:, :S], planes[:, off1 : off1 + S + 1],
                      planes[:, off2 : off2 + S + 1]], 1)
    onehot = (cols[:, :, None] == torch.arange(4, device=dev)).to(
        torch.bfloat16).reshape(B, 4 * (3 * S + 2))
    del cols
    seg = torch.zeros((N, B), dtype=torch.bfloat16, device=dev)
    seg[win, torch.arange(B, device=dev)] = (
        ok & (stats[:, 1] >= 0)).to(torch.bfloat16)

    def peak_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base

    def kernel():
        return vt.vote_tables(planes, stats, win_ptr, ok, N, S)

    def plain():
        return vt.vote_tables_plain(planes, stats, win, ok, N, S)

    def library():
        return torch.matmul(seg, onehot)

    ms, turns = v1_launch_ms(kernel)
    plain_ms = one_call_ms(plain, n_med)
    lib_ms = v1_launch_ms(library, n=10)[0]
    tabs = kernel()
    by_lib = library().float().round().to(torch.int32)
    lib_equal = bool(
        torch.equal(by_lib[:, : 4 * S].reshape(N * S, 4), tabs[0])
        and torch.equal(by_lib[:, 4 * S : 8 * S + 4].reshape(-1, 4), tabs[2])
        and torch.equal(by_lib[:, 8 * S + 4 :].reshape(-1, 4), tabs[3]))
    del by_lib, tabs
    bound_ms, bound_by = vote_tables_bound(B, N, S)
    rec["bench_shape"] = {
        "N": N, "B": B, "S": S, "ms": ms, "ms_turns": turns,
        "ms_one_call": one_call_ms(kernel, n_med),
        "host_us_a_call": host_us(kernel),
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "torch.matmul(seg (N, B) bf16, onehot (B, 12S+8) bf16)",
        "library_counts_equal": lib_equal,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "share_of_bound": bound_ms / ms,
        "v1_peak_bytes": peak_bytes(kernel),
        "plain_peak_bytes": peak_bytes(plain),
        "plan": vt.launch_plan(N, S, dev),
        "ptxas": ptxas_of("vote_tables_kernel"),
    }
    rec["max_abs_err"] = 0  # any difference above raised
    del planes, stats, win, win_ptr, ok, kept, seg, onehot
    rec["consensus_call_profile"] = profile_consensus(dev, windows)
    rec["seconds"] = time.time() - t_start
    return rec


def phase_consensus_wavefront(dev, windows, rowscan_out, n_check=256):
    """The consensus workload under the wavefront engine: windows/s, the
    card's output equal to the CPU plain path's on ``n_check`` windows,
    and the count of windows whose consensus differs from the row-scan
    engine's (a fact, not a check: the two bands differ).  Returns
    (record, the card's consensus)."""
    import torch

    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    with nw_engine("wavefront"):
        batched_consensus(windows[:64], device=dev)  # first-call warm-up
        torch.cuda.synchronize()
        reset_launches()
        cd.PROF.clear()
        with launch_log() as by_bucket:
            t0 = time.time()
            out = batched_consensus(windows, device=dev)
            dt = time.time() - t0
        n_launch = launches()["wavefront_votes"]
        n_v1 = check_v1_launches(cd.PROF, 1, "phase 9")
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
        "vote_tables_launches": n_v1, "launches_by_bucket": by_bucket,
        "cpu_plain_equal_windows": n_check,
        "windows_differing_from_rowscan": sum(
            a != b for a, b in zip(out, rowscan_out)
        ),
    }, out


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


def _run_cli(dev, scale, threads, out, log_path, mesh=None):
    """The pipeline CLI on ``out`` (``run_pipeline`` over ``mesh`` when
    one is given); returns its record (stage times, contigs, NG50,
    recall, the launches of that run)."""
    from haslr_tpu_torch.aligner import map as amap
    from haslr_tpu_torch.cli import haslr as cli

    (g_path, sr_path, lr_path), _ = _data_paths(scale)
    argv = ["-o", out, "-g", str(scale), "-l", lr_path, "-x", "pacbio",
            "-s", sr_path, "-t", str(threads), "--device", dev.type]
    reset_launches()
    t0 = time.time()
    with launch_log() as by_bucket, open(log_path, "w") as log, \
            contextlib.redirect_stdout(log):
        if mesh is None:
            rc = cli.main(argv)
        else:
            rc = 0
            cli.run_pipeline(cli.parse_options(argv)[0], dev, mesh=mesh)
        wall = time.time() - t0
        counts = launches()
    if rc != 0:
        raise AssertionError(f"pipeline exit code {rc}")
    return {
        "launches_by_bucket": by_bucket,
        "scale_bp": scale, "threads": threads, "wall_s": wall,
        "stages_s": stage_seconds(), "align_phases_s": dict(amap.PROF),
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


def phase_mesh_consensus(mesh, windows, want, phase, engine="rowscan"):
    """The consensus workload through ``mesh`` under NW ``engine``:
    windows/s, the votes kernel's launches (each shard launches its own),
    and the output equal to ``want`` (phase ``phase``'s, one device under
    the same engine) on every window."""
    from haslr_tpu_torch.kernels import consensus_dense as cd
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    kernel = f"{engine}_votes"
    with nw_engine(engine):
        reset_launches()
        cd.PROF.clear()
        with launch_log() as by_bucket:
            t0 = time.time()
            out = batched_consensus(windows, mesh=mesh)
            dt = time.time() - t0
        n_launch = launches()[kernel]
        n_v1 = check_v1_launches(cd.PROF, mesh.size,
                                 f"mesh consensus, {engine}")
    n_diff = sum(a != b for a, b in zip(out, want))
    if n_diff or len(out) != len(want):
        raise AssertionError(f"{engine} mesh consensus differs from phase "
                             f"{phase}'s on {n_diff} of {len(windows)} "
                             "windows")
    if n_launch < mesh.size:
        raise AssertionError(f"{engine} mesh consensus launched {kernel} "
                             f"{n_launch} times")
    return {"windows": len(windows), "windows_per_s": len(windows) / dt,
            "seconds": dt, f"{kernel}_launches": n_launch,
            "vote_tables_launches": n_v1, "launches_by_bucket": by_bucket,
            f"windows_equal_to_phase_{phase}": len(windows)}


def phase_mesh_e2e(dev, mesh, scale, threads, tmp):
    """The 4.6 Mb pipeline through ``run_pipeline(..., mesh=mesh)`` into
    a new directory: its SR contigs and final assembly equal phase 6's
    byte for byte."""
    rec = _run_cli(dev, scale, threads, os.path.join(tmp, "e2e_mesh"),
                   os.path.join(tmp, "e2e_mesh.log"), mesh=mesh)
    for name in ("sr_k49_a3.contigs.fa", "asm.final.fa"):
        paths = [final_fasta(os.path.join(tmp, d)) if name == "asm.final.fa"
                 else os.path.join(tmp, d, name) for d in ("e2e", "e2e_mesh")]
        with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"mesh pipeline: {name} differs from "
                                     "phase 6's")
    rec["identical_to_phase_6"] = ["sr_k49_a3.contigs.fa", "asm.final.fa"]
    return rec


# one rank of the two-process mapping: joins the gloo group and maps its
# host shard of the reads on the device named
_RANK = r"""
import sys

import torch.distributed as td

from haslr_tpu_torch import dist
from haslr_tpu_torch.aligner.map import map_reads

coord, rank, ctg, lr, out, device = sys.argv[1:7]
dist.initialize(coord, 2, int(rank), timeout_s=300)
print(map_reads(ctg, lr, out, host_shard=dist.host_shard(), device=device))
td.destroy_process_group()
"""


def mapping_data(d, genome_len=200_000, seed=17):
    """Contigs (2 kb every 1.5 kb of a simulated genome with repeats) and
    5x long reads at 6 % error in ``d``, as the JAX package's
    multi-process test makes them; returns (contigs, reads) paths."""
    import numpy as np

    from haslr_tpu_torch.testutil import simulate

    ctg, lr = os.path.join(d, "ctg.fa"), os.path.join(d, "lr.fa")
    rng = np.random.default_rng(seed)
    genome = simulate.genome_with_repeats(
        rng, genome_len, n_families=4, copies_per_family=3, repeat_len=300)
    with open(ctg, "w") as fp:
        for i in range(0, len(genome) - 1500, 1500):
            fp.write(f">{i // 1500}\n{genome[i:i + 2000]}\n")
    with open(lr, "w") as fp:
        for r in simulate.make_reads(rng, genome, coverage=5.0,
                                     mean_len=6000, error_rate=0.06):
            fp.write(f">{r.rid}\n{r.seq}\n")
    return ctg, lr


def phase_two_process_mapping(tmp, device="cuda:0", genome_len=200_000):
    """Two processes under gloo, each mapping its host shard of the reads
    of a simulated genome (:func:`mapping_data`) on ``device``; their PAF
    lines, together, equal one process's.  The ranks are ended here
    whatever happens."""
    import socket

    from haslr_tpu_torch.aligner.map import map_reads

    d = os.path.join(tmp, "two_process")
    os.makedirs(d)
    ctg, lr = mapping_data(d, genome_len)
    t0 = time.time()
    single = os.path.join(d, "single.paf")
    n_single = map_reads(ctg, lr, single, device=device)
    single_s = time.time() - t0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=ROOT,
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    shards = [os.path.join(d, f"shard{i}.paf") for i in range(2)]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, coord, str(i), ctg, lr, shards[i],
         device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    ) for i in range(2)]
    try:
        said = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_out, err) in zip(procs, said):
        if p.returncode != 0:
            raise AssertionError(f"mapping rank failed (exit "
                                 f"{p.returncode}): {err[-2000:]}")
    ranks_s = time.time() - t0
    with open(single) as f:
        want = sorted(f.readlines())
    got = []
    for s_path in shards:
        with open(s_path) as f:
            got.extend(f.readlines())
    if sorted(got) != want or not want:
        raise AssertionError("two-process PAF != one process's")
    return {"genome_bp": genome_len, "records": n_single,
            "records_by_rank": [int(out.split()[-1]) for out, _ in said],
            "single_process_s": single_s, "two_ranks_s": ranks_s,
            "paf_lines_equal": len(want)}


def phase_haslr_assemble(tmp, device="cuda"):
    """The standalone ``haslr_assemble`` on the golden inputs (left in
    ``tmp`` by phase 4), on ``device``: the pinned device-engine
    bytes."""
    from haslr_tpu_torch.cli import haslr_assemble

    out = os.path.join(tmp, "haslr_assemble")
    t0 = time.time()
    with open(os.path.join(tmp, "haslr_assemble.log"), "w") as log, \
            contextlib.redirect_stderr(log):
        rc = haslr_assemble.main([
            "-c", os.path.join(tmp, "contigs.fa"),
            "-l", os.path.join(tmp, "lr.fa"),
            "-m", os.path.join(tmp, "map.paf"), "-d", out,
            "--device", device,
        ])
    if rc != 0:
        raise AssertionError(f"haslr_assemble exit code {rc}")
    gold = os.path.join(ROOT, "tests", "golden", "expected")
    for name in ("asm.final.fa", "asm.final.ann"):
        with open(f"{gold}/tpu.{name}", "rb") as f, \
                open(f"{out}/{name}", "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"haslr_assemble {name} != golden")
    return {"identical": ["tpu.asm.final.fa", "tpu.asm.final.ann"],
            "seconds": time.time() - t0}


def _same_counts(want, got, what):
    """(hi, lo, count) arrays equal in dtype and value, or raise."""
    import numpy as np

    for name, a, b in zip(("hi", "lo", "count"), want, got, strict=True):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the native "
                                 "count")
    return len(want[0])


def phase_kmer_counters(dev, scale, tmp, k=49, min_count=3):
    """Phase 12: the native counter, ``count_kmers_device`` on the whole
    concatenated stream (separators between reads) and
    ``count_kmers_streaming`` at its defaults on phase 6's short reads,
    array for array; then the SR stage through the streaming counter,
    byte for byte phase 6's SR contigs.  Each count is timed from reads
    in memory to sorted arrays on the host."""
    import numpy as np
    import torch

    from haslr_tpu_torch import native
    from haslr_tpu_torch.kernels import kmer as kk
    from haslr_tpu_torch.kernels import kmer_stream as ks
    from haslr_tpu_torch.sr import assemble_sr as asr

    (_g, sr_path, _lr), _ = _data_paths(scale)
    codes, offsets = asr._load_flat([sr_path])
    n_bases = len(codes)
    t0 = time.time()
    want = native.count_kmers_native(codes, offsets, k, min_count,
                                     n_threads=os.cpu_count() or 1)
    native_s = time.time() - t0
    reads = [codes[offsets[i] : offsets[i + 1]]
             for i in range(len(offsets) - 1)]
    with_seps = asr.load_read_codes([sr_path])

    def rate(sec):
        return {"seconds": sec, "mbases_per_s": n_bases / sec / 1e6}

    rec = {"bases": n_bases, "reads": len(reads), "codes_with_seps":
           len(with_seps), "k": k, "min_count": min_count,
           "native": {**rate(native_s), "threads": os.cpu_count()}}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    got = kk.count_kmers_device(with_seps, k, min_count, device=dev)
    rec["device"] = {**rate(time.time() - t0),
                     "max_memory_allocated": torch.cuda.max_memory_allocated(
                         dev),
                     "solid_kmers": _same_counts(want, got,
                                                 "count_kmers_device")}
    del with_seps, got
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ks.PROF.clear()
    t0 = time.time()
    got = ks.count_kmers_streaming(reads, k, min_count, device=dev)
    rec["streaming"] = {**rate(time.time() - t0),
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(dev),
                        "prof_s": dict(ks.PROF),
                        "solid_kmers": _same_counts(
                            want, got, "count_kmers_streaming")}
    del reads, got
    out = os.path.join(tmp, "sr_streaming.contigs.fa")
    t0 = time.time()
    asr.assemble_short_reads([sr_path], out, kmer_size=k,
                             min_abundance=min_count, streaming=True,
                             torch_device=dev)
    with open(out, "rb") as f, \
            open(os.path.join(tmp, "e2e", "sr_k49_a3.contigs.fa"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("assemble_short_reads(streaming=True): SR "
                                 "contigs differ from phase 6's")
    rec["sr_stage_streaming"] = {"seconds": time.time() - t0,
                                 "prof_s": dict(asr.PROF),
                                 "identical_to_phase_6":
                                     "sr_k49_a3.contigs.fa"}
    return rec


def phase_kmer_sharded(dev, mesh, tmp, k=49, min_count=2):
    """Phase 12b: the streaming counter's sharded phase-2 merge over
    ``mesh`` (one prefix partition a device) and its disk spill, on
    11c's long reads, each equal to the native count."""
    from haslr_tpu_torch import native
    from haslr_tpu_torch.kernels import kmer_stream as ks

    codes, offsets, _n, _c = native.read_fastx_encoded(
        os.path.join(tmp, "two_process", "lr.fa"))
    want = native.count_kmers_native(codes, offsets, k, min_count,
                                     n_threads=os.cpu_count() or 1)
    reads = [codes[offsets[i] : offsets[i + 1]]
             for i in range(len(offsets) - 1)]
    rec = {"bases": len(codes), "reads": len(reads), "k": k,
           "min_count": min_count, "chunk_bases": 1 << 18}
    for tag, kw in (("sharded", {"mesh": mesh}),
                    ("spilled", {"spill_dir": os.path.join(tmp, "kmer_spill"),
                                 "device": dev})):
        ks.PROF.clear()
        t0 = time.time()
        got = ks.count_kmers_streaming(reads, k, min_count,
                                       chunk_bases=1 << 18, **kw)
        rec[tag] = {"seconds": time.time() - t0, "prof_s": dict(ks.PROF),
                    "solid_kmers": _same_counts(
                        want, got, f"count_kmers_streaming ({tag})")}
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
    # the vote planes down to the vote tables; the other outputs of every
    # kernel are held in 3a and 3c
    for S, W in ((512, 128), (1024, 128), (2048, 256), (4096, 512)):
        err = check_votes(dev, S, W, 64, S)
        check("rowscan_votes", err)
        check("vote_tables", err)
    for S, W, B in ((512, 128, 64), (1024, 128, 64), (2048, 256, 32),
                    (4096, 512, 16)):
        err = check_votes(dev, S, W, B, S + 4, "wavefront")
        check("wavefront_votes", err)
        check("vote_tables", err)
    # the extension's S=256 bucket at its own MAXR; every route of the
    # row-scan design, (C, WPR) by W and by B on either side of the
    # small-launch limit; then bands and row widths that run masked or
    # padded
    route_shapes = (
        (256, 256, 128, 64),
        (512, 512, 128, 64), (1024, 1024, 128, 64), (2048, 2048, 256, 32),
        (1024, 1024, 512, 24), (1024, 1024, 512, 520),
        (4096, 4096, 512, 16), (2048, 2048, 512, 256),
        (512, 512, 32, 64), (512, 512, 96, 64), (1024, 1024, 160, 32),
        (1024, 1024, 480, 16), (1024, 1024, 320, 520),
        (510, 510, 128, 64), (510, 509, 96, 64), (301, 299, 32, 64),
        (2047, 2045, 256, 32), (1022, 1021, 512, 16),
    )
    rowscan = ("rowscan_votes", "rowscan_cigar", "rowscan_mapping")
    t_routes = time.time()
    took = []
    # then the MAXR-overflow batch, and the extension's longest bucket
    # through its kernel only (the plain versions walk 16,384 rows each)
    for R, D, W, B, *tag in (*route_shapes,
                             (256, 256, 128, 32, "MAXR overflow"),
                             (16384, 16384, 512, 32, "CIGAR runs only")):
        only = ("rowscan_cigar",) if tag[:1] == ["CIGAR runs only"] \
            else rowscan
        overflow = tag[:1] == ["MAXR overflow"]
        err, C, wpr = check_shape(dev, R, D, W, B, 23 if overflow else R + 11,
                                  overflow=overflow, only=only)
        for name in only:
            check(name, err)
        took.append([R, D, W, B, C, wpr, *tag])
    want = {(4, 1), (8, 1), (16, 1), (4, 4)}
    if {(C, wpr) for _R, _D, _W, _B, C, wpr, *_ in took} != want:
        raise AssertionError(f"phase 3a did not take every route: {took}")
    _line("3a row-scan routes == plain", tolerance=TOL,
          kernels=list(rowscan), shapes_R_D_W_B_C_WPR=took,
          max_abs_err={k: errs[k] for k in rowscan},
          seconds=time.time() - t_routes)
    # every route of the wavefront design, (C, WPR) by W and by B on either
    # side of the small-launch limit; masked bands; R != D and row widths
    # that are no multiples of four; the mapping kernel's longest bucket
    wf_shapes = (
        (512, 512, 128, 64), (2048, 2048, 256, 32), (1024, 1024, 512, 24),
        (1024, 1024, 512, 520), (4096, 4096, 512, 16),
        (512, 512, 32, 64), (512, 512, 96, 64), (1024, 1024, 160, 32),
        (1024, 1024, 480, 16), (1024, 1024, 320, 520),
        (510, 509, 128, 64), (301, 299, 32, 64), (2047, 2045, 256, 32),
        (1022, 1021, 512, 16), (600, 512, 128, 32), (512, 600, 128, 32),
    )
    wavefront = ("wavefront_votes", "wavefront_mapping", "wavefront_dirs")
    t_routes = time.time()
    took = []
    for R, D, W, B, *tag in (*wf_shapes,
                             (16384, 16384, 512, 4, "mapping only")):
        only = ("wavefront_mapping",) if tag else wavefront
        err, C, wpr = check_wavefront_shape(dev, R, D, W, B,
                                            29 if tag else R + 13, only)
        for name in only:
            check(name, err)
        took.append([R, D, W, B, C, wpr, *tag])
    if {(C, wpr) for _R, _D, _W, _B, C, wpr, *_ in took} != want:
        raise AssertionError(f"phase 3c did not take every route: {took}")
    _line("3c wavefront routes == plain", tolerance=TOL,
          kernels=list(wavefront), shapes_R_D_W_B_C_WPR=took,
          max_abs_err={k: errs[k] for k in wavefront},
          seconds=time.time() - t_routes)
    times = {S: time_pair(dev, S, 128, 2048, S + 2) for S in (512, 1024)}
    big = time_pair(dev, 16384, 512, 32, 16386,
                    only=("rowscan_cigar", "wavefront_mapping"),
                    with_plain=False)
    for name in times[512]:
        _line("3b time and bound", kernel=name, card=smi,
              **{f"B2048_S{S}_W128": t[name] for S, t in times.items()},
              **({"B32_S16384_W512": big[name]} if name in big else {}))
    _line("3 kernel == plain", tolerance=TOL,
          vote_tables_shapes="B1: S,W = 512,128 1024,128 2048,256 4096,512;"
                             " B4: 512,128 1024,128 2048,256 4096,512",
          other_outputs="every shape of 3a and 3c",
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
        v1 = phase_vote_tables(dev, windows)
        _line("5b vote tables == plain", card=smi, **v1)
        check("vote_tables", v1["max_abs_err"])

        threads = os.cpu_count() or 1
        rec = phase_e2e(dev, E2E_SCALE, threads, tmp)
        _line("6 end to end", device=kind, **rec)
        _check_e2e(rec, ("rowscan_votes", "rowscan_cigar", "vote_tables"),
                   "end to end")
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

        cons_wf, wavefront_out = phase_consensus_wavefront(dev, windows,
                                                           rowscan_out)
        _line("9 consensus, wavefront", device=kind, **cons_wf)

        rec_wf = phase_e2e_wavefront(dev, E2E_SCALE, threads, tmp)
        _line("10 end to end, wavefront", device=kind, **rec_wf)
        _check_e2e(rec_wf, ("wavefront_votes", "wavefront_mapping",
                            "vote_tables"),
                   "end to end under the wavefront engine")
        path_launches["e2e_wf"] = rec_wf["launches"]

        from haslr_tpu_torch.dist.mesh import Mesh, make_mesh

        n_cards = torch.cuda.device_count()
        mesh = make_mesh(2) if n_cards >= 2 else Mesh(["cuda:0", "cuda:0"])
        proves = (
            "the split and the summed vote tables exact with the kernels "
            "on the card; a one-card mesh shows neither a launch on a "
            "second card nor a speed-up" if len(set(mesh.devices)) == 1
            else "the split, the summed tables and launches on two cards")
        _line("11 mesh", mesh=[str(d) for d in mesh.devices],
              distinct_cards=len(set(mesh.devices)), visible_cards=n_cards,
              proves=proves)
        _line("11a mesh consensus", card=smi,
              **phase_mesh_consensus(mesh, windows, rowscan_out, 5))
        rec_mesh = phase_mesh_e2e(dev, mesh, E2E_SCALE, threads, tmp)
        _line("11b mesh end to end", card=smi, **rec_mesh)
        _check_e2e(rec_mesh, ("rowscan_votes", "rowscan_cigar",
                              "vote_tables"),
                   "end to end on the mesh")
        _line("11c two-process mapping", card=smi,
              **phase_two_process_mapping(tmp))
        _line("11d haslr_assemble", card=smi, **phase_haslr_assemble(tmp))
        _line("11e mesh consensus, wavefront", card=smi,
              **phase_mesh_consensus(mesh, windows, wavefront_out, 9,
                                     "wavefront"))

        _line("12 k-mer counters", card=smi,
              **phase_kmer_counters(dev, E2E_SCALE, tmp))
        _line("12b k-mer merge on the mesh, spill", card=smi,
              mesh=[str(d) for d in mesh.devices],
              **phase_kmer_sharded(dev, mesh, tmp))

    # the NW kernels at B=2048, S=512, W=128 (no PyTorch call computes a
    # banded NW); V1 at the consensus workload's round, beside one matmul
    timed = {**times[512], "vote_tables": v1["bench_shape"]}
    return [
        json.dumps({"kernels": [
            {"name": name, "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": path_launches[path][name],
             "max_abs_err": errs[name],
             **{k: timed[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")},
             "library_ms": timed[name].get("library_ms")}
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


def main_v1(root):
    """``--v1``: phase 5b's synthetic rounds with the package in
    ``root``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(root))
    from haslr_tpu_torch.kernels import vote_tables as vt

    rec = v1_rounds(torch.device("cuda"))
    _line("v1 rounds", card=_smi(), package=os.path.dirname(vt.__file__),
          **rec)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--v1"]:
        main_v1(sys.argv[2] if len(sys.argv) > 2 else ROOT)
        raise SystemExit(0)
    try:
        last_lines = main()
    finally:
        killed = stop_children()
    if killed:
        raise SystemExit(f"chip_smoke: processes still running at the end, "
                         f"killed: {killed}")
    print("\n".join(last_lines))
