"""Read formatting and subsampling (fastutils replacement).

Replaces the fastutils invocations of the reference driver:

- ``format -i fofn -d --fofn``: rename reads to sequential numeric ids
  (``bin/haslr.py:227``) — required because the assembler parses PAF name
  columns as integers (``Longread.cpp:286-289``);
- ``format -i in -m N -c``: drop sequences shorter than N, keep comments
  (``bin/haslr.py:143``);
- ``subsample -i fofn -d D -g G -lnk --fofn``: keep the *longest* reads
  totalling D x G bases, renamed to numeric ids (``bin/haslr.py:247``).
"""

from __future__ import annotations

from haslr_tpu_torch.core import io as cio


def format_rename(inputs: list[str], out_path: str) -> int:
    """Concatenate inputs, renaming records to 0..n-1 (fastutils format -d)."""
    n = 0
    with open(out_path, "w") as fp:
        for path in inputs:
            for rec in cio.read_fastx(path):
                fp.write(f">{n}\n{rec.seq}\n")
                n += 1
    return n


def format_min_len(in_path: str, out_path: str, min_len: int,
                   keep_comment: bool = True) -> int:
    """Length filter keeping comments (fastutils format -m N -c)."""
    n = 0
    with open(out_path, "w") as fp:
        for rec in cio.read_fastx(in_path):
            if len(rec.seq) < min_len:
                continue
            header = f">{rec.name}"
            if keep_comment and rec.comment:
                header += f" {rec.comment}"
            fp.write(f"{header}\n{rec.seq}\n")
            n += 1
    return n


# inputs above this many bytes take the two-pass streaming path: the
# in-RAM variant holds EVERY read as a string before sorting, which at
# CHM1 scale (~100 Gbp of long reads) is a 100+ GB OOM
STREAM_THRESHOLD_BYTES = 1 << 30


def _kept_mask_by_length(lens, budget: float):
    """Boolean keep-mask implementing fastutils' policy: longest reads
    first (ties broken by input order) until the total base budget is
    reached (the read that crosses the budget is still kept)."""
    import numpy as np

    lens = np.asarray(lens, np.int64)
    order = np.argsort(-lens, kind="stable")
    csum = np.cumsum(lens[order])
    # keep reads while the total BEFORE them is under budget
    n_keep = int(np.searchsorted(csum - lens[order], budget, side="left"))
    keep = np.zeros(len(lens), bool)
    keep[order[:n_keep]] = True
    return keep


def subsample_longest(
    inputs: list[str], out_path: str, depth: float, genome_size: int,
    streaming: bool | None = None,
) -> int:
    """Keep the longest reads totalling ``depth * genome_size`` bases,
    renamed to sequential numeric ids (fastutils subsample -lnk).

    Two modes with the same kept SET of reads:

    - in-RAM (small inputs): reads are emitted longest-first, matching
      the historical output order;
    - streaming (inputs over ``STREAM_THRESHOLD_BYTES``): pass 1 records
      only lengths, pass 2 re-reads and writes the kept reads in INPUT
      order — O(n) int64 host memory regardless of input size.  The
      order difference only permutes the numeric ids downstream treats
      as opaque."""
    import os

    budget = depth * genome_size
    if streaming is None:
        streaming = (
            sum(os.path.getsize(p) for p in inputs)
            > STREAM_THRESHOLD_BYTES
        )
    if not streaming:
        reads = []
        for path in inputs:
            for rec in cio.read_fastx(path):
                reads.append(rec.seq)
        reads.sort(key=len, reverse=True)
        total = 0
        kept = []
        for seq in reads:
            if total >= budget:
                break
            kept.append(seq)
            total += len(seq)
        with open(out_path, "w") as fp:
            for i, seq in enumerate(kept):
                fp.write(f">{i}\n{seq}\n")
        return len(kept)

    lens: list[int] = []
    for path in inputs:
        for rec in cio.read_fastx(path):
            lens.append(len(rec.seq))
    keep = _kept_mask_by_length(lens, budget)
    n = 0
    i = 0
    with open(out_path, "w") as fp:
        for path in inputs:
            for rec in cio.read_fastx(path):
                if keep[i]:
                    fp.write(f">{n}\n{rec.seq}\n")
                    n += 1
                i += 1
    return n
