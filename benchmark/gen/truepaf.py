"""The true alignments of the long reads to the contigs, as PAF.

Each record is one read's overlap with one placement of a contig,
trimmed so that it starts and ends on an aligned base, with its CIGAR
taken from the mutation's own edit operations (minimap2's conventions:
the CIGAR in the contig's order, a '-' strand's query coordinates in the
read's own frame, ``tp:A:P``, ``cg:Z:``).  Records of a read are
consecutive and ordered by query start, as the assembler expects.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.gen.contigs import Contigs
from benchmark.gen.longreads import DEL, MATCH, LongReads

M_OP, I_OP, D_OP = 0, 1, 2
OP_CHARS = np.frombuffer(b"MID", np.uint8)
BLOCK_COLUMNS = 1 << 24


@dataclass
class Overlaps:
    """Read x contig-placement pairs and their aligned template span."""
    read: np.ndarray        # int64 read index
    place: np.ndarray       # int64 placement index
    t0: np.ndarray          # int64 first template index (global) aligned
    t1: np.ndarray          # int64 one past the last


def prefix(a) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, out=out[1:])
    return out


def overlaps(reads: LongReads, contigs: Contigs, min_overlap: int,
             places=None) -> Overlaps:
    """Every pair of a read and a contig placement (of ``places``, all by
    default) that share ``min_overlap`` genome bases, trimmed to aligned
    bases at both ends."""
    if places is None:
        places = np.arange(len(contigs.pl_start))
    ps, pe = contigs.pl_start[places], contigs.pl_end[places]
    tlen = np.diff(reads.tpl_off)
    gs, ge = reads.tpl_start, reads.tpl_start + tlen
    i_lo = np.searchsorted(pe, gs, side="right")
    i_hi = np.searchsorted(ps, ge, side="left")
    cnt = np.maximum(i_hi - i_lo, 0)
    read = np.repeat(np.arange(len(gs)), cnt)
    first = np.repeat(i_lo, cnt)
    k = np.arange(len(read)) - np.repeat(prefix(cnt)[:-1], cnt)
    pi = first + k
    a = np.maximum(gs[read], ps[pi])
    b = np.minimum(ge[read], pe[pi])
    keep = b - a >= min_overlap
    read, pi, a, b = read[keep], pi[keep], a[keep], b[keep]
    base = reads.tpl_off[read] - gs[read]
    t0, t1 = a + base, b + base
    kind = reads.kind
    while True:
        m = (t0 < t1) & (kind[np.minimum(t0, len(kind) - 1)] == DEL)
        if not m.any():
            break
        t0 = t0 + m
    while True:
        m = (t1 > t0) & (kind[np.maximum(t1 - 1, 0)] == DEL)
        if not m.any():
            break
        t1 = t1 - m
    keep = t1 - t0 >= 2
    return Overlaps(read[keep], places[pi[keep]], t0[keep], t1[keep])


def _digits(n: np.ndarray) -> np.ndarray:
    d = np.ones(len(n), np.int64)
    p = 10
    while (n >= p).any():
        d += n >= p
        p *= 10
    return d


def cigar_bytes(reads: LongReads, ov: Overlaps, rev: np.ndarray):
    """The CIGAR strings of the overlaps, ``rev`` marking those written
    in the contig's reverse order: (bytes, offsets a record)."""
    parts, lens = [], []
    a = 0
    span = ov.t1 - ov.t0
    cum = prefix(span)
    while a < len(span):
        b = int(np.searchsorted(cum, cum[a] + BLOCK_COLUMNS,
                                side="right")) - 1
        b = max(b, a + 1)
        buf, per = _cigar_block(reads, ov.t0[a:b], ov.t1[a:b], rev[a:b])
        parts.append(buf)
        lens.append(per)
        a = b
    per = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    return (np.concatenate(parts) if parts else np.zeros(0, np.uint8),
            prefix(per))


def _cigar_block(reads, t0, t1, rev):
    span = t1 - t0
    pid = np.repeat(np.arange(len(span)), span)
    pos = np.arange(int(span.sum())) + np.repeat(t0 - prefix(span)[:-1], span)
    main = np.where(reads.kind[pos] == DEL, D_OP, M_OP).astype(np.uint8)
    extra = reads.ins[pos] & (pos != np.repeat(t1 - 1, span))
    n_col = 1 + extra.astype(np.int64)
    off = prefix(n_col)[:-1]
    col = np.empty(int(n_col.sum()), np.uint8)
    col[off] = main
    col[off[extra] + 1] = I_OP
    cpid = np.empty(len(col), np.int64)
    cpid[off] = pid
    cpid[off[extra] + 1] = pid[extra]
    start = np.concatenate([[True], (col[1:] != col[:-1])
                            | (cpid[1:] != cpid[:-1])])
    rs = np.nonzero(start)[0]
    run_len = np.diff(np.concatenate([rs, [len(col)]]))
    run_op = col[rs]
    run_pid = cpid[rs]
    # the runs of a reversed record in reverse order
    n_runs = np.bincount(run_pid, minlength=len(span))
    r_off = prefix(n_runs)
    r = np.arange(len(rs))
    lo, hi = r_off[run_pid], r_off[run_pid + 1] - 1
    order = np.where(rev[run_pid], lo + hi - r, r)
    run_len, run_op = run_len[order], run_op[order]
    nd = _digits(run_len)
    width = nd + 1
    boff = prefix(width)
    buf = np.empty(int(boff[-1]), np.uint8)
    for d in range(int(nd.max()) if len(nd) else 0):
        m = nd > d
        buf[boff[:-1][m] + d] = (48 + (run_len[m] // 10 ** (nd[m] - 1 - d))
                                 % 10).astype(np.uint8)
    buf[boff[:-1] + nd] = OP_CHARS[run_op]
    per_pair = np.bincount(run_pid, weights=width, minlength=len(span))
    return buf, per_pair.astype(np.int64)


@dataclass
class Records:
    """PAF fields of the overlaps, in the file's order."""
    read: np.ndarray
    contig: np.ndarray
    q_len: np.ndarray
    q_start: np.ndarray
    q_end: np.ndarray
    minus: np.ndarray
    t_len: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    n_match: np.ndarray
    n_block: np.ndarray
    rev: np.ndarray         # the CIGAR runs in the contig's reverse order
    t0: np.ndarray
    t1: np.ndarray


def records(reads: LongReads, contigs: Contigs, ov: Overlaps) -> Records:
    consumed = prefix((reads.kind != DEL).astype(np.int64) + reads.ins)
    matched = prefix(reads.kind == MATCH)
    inserted = prefix(reads.ins)
    r, p, t0, t1 = ov.read, ov.place, ov.t0, ov.t1
    q_len = np.diff(reads.seq_off)[r]
    fq0 = consumed[t0] - consumed[reads.tpl_off[r]]
    fq1 = fq0 + consumed[t1] - consumed[t0] - reads.ins[t1 - 1]
    rstrand = reads.strand[r]
    q_start = np.where(rstrand, q_len - fq1, fq0)
    q_end = np.where(rstrand, q_len - fq0, fq1)
    g0 = reads.tpl_start[r] + (t0 - reads.tpl_off[r])
    g1 = reads.tpl_start[r] + (t1 - reads.tpl_off[r])
    ps, pe, prev = contigs.pl_start[p], contigs.pl_end[p], contigs.pl_rev[p]
    t_start = np.where(prev, pe - g1, g0 - ps)
    t_end = np.where(prev, pe - g0, g1 - ps)
    n_match = matched[t1] - matched[t0]
    n_block = (t1 - t0) + inserted[t1 - 1] - inserted[t0]
    contig = contigs.pl_contig[p]
    order = np.lexsort((q_end, q_start, r))
    t_len = contigs.lengths()[contig]
    cols = (r, contig, q_len, q_start, q_end, rstrand ^ prev, t_len,
            t_start, t_end, n_match, n_block, prev, t0, t1)
    return Records(*(c[order] for c in cols))


def write_paf(path: str, reads: LongReads, contigs: Contigs,
              min_overlap: int, places=None) -> Records:
    """Write the true PAF of the reads against the contigs (placements
    ``places``, all by default); returns its records."""
    rec = records(reads, contigs, overlaps(reads, contigs, min_overlap,
                                           places))
    cig, off = cigar_bytes(reads, Overlaps(rec.read, None, rec.t0, rec.t1),
                           rec.rev)
    with open(path, "wb") as fp:
        for i in range(len(rec.read)):
            fp.write(
                f"{rec.read[i]}\t{rec.q_len[i]}\t{rec.q_start[i]}\t"
                f"{rec.q_end[i]}\t{'-' if rec.minus[i] else '+'}\t"
                f"{rec.contig[i]}\t{rec.t_len[i]}\t{rec.t_start[i]}\t"
                f"{rec.t_end[i]}\t{rec.n_match[i]}\t{rec.n_block[i]}\t60\t"
                f"tp:A:P\tcg:Z:".encode())
            fp.write(cig[off[i] : off[i + 1]].tobytes())
            fp.write(b"\n")
    return rec
