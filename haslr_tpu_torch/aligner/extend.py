"""Base-level extension on a torch device (port of
:func:`haslr_tpu.aligner.extend.batch_align_segments`).

Gap segments between chain anchors are length-bucketed exactly as in the
reference (S a power of two >= 128, W = 128 / 256 / 512) and aligned on
the device by the active engine (:data:`haslr_tpu_torch.kernels.nw.
ENGINE`), as in the reference:

- ``"rowscan"`` (default): the row-scan CIGAR-run traceback
  (:func:`haslr_tpu_torch.kernels.nw_rowscan.cigar_runs_device_raw`),
  decoded on host by the shared native run decoder;
- ``"wavefront"``: the mapping branch — the (B, S) read->draft mapping
  (:func:`haslr_tpu_torch.kernels.nw.align_mapping_device_raw`), narrowed
  to int16 on the device before the copy and decoded on host by
  ``native.mapping_cigars_native`` (or ``mapping_to_cigar`` without the
  library).

The host fallbacks are the reference's: :func:`nw_cigar` for short,
empty, band-incompatible (``|lq - lt| >= W/2 - 4``) or S > 16384 segments
and for rows whose run list overflowed MAXR.  The host half of the module
(:func:`nw_cigar`, :func:`mapping_to_cigar`, the run decoder and the
chain -> parts -> CIGAR helpers) is the port's own copy of the same
functions of :mod:`haslr_tpu.aligner.extend`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from haslr_tpu_torch import native
from haslr_tpu_torch.core import cigar as ccigar
from haslr_tpu_torch.device import resolve_device
from haslr_tpu_torch.kernels import nw
from haslr_tpu_torch.kernels import nw_rowscan as rsk
from haslr_tpu_torch.kernels.consensus_dense import _band_width

NEG_H = -(10**12)

# per-phase wall clock of the last batch_align_segments call
PROF: dict[str, float] = {}


def batch_align_segments(segments, match=2, mismatch=-4, gap=-2,
                         device: torch.device | str | None = None):
    """Globally align many (q_codes, t_codes) segment pairs; returns a
    list of (ops, lens, n_eq) parallel to ``segments``.  ``device``: the
    card unless the caller says ``"cpu"``."""
    device = resolve_device(device)
    PROF.clear()

    def _prof(key, dt):
        PROF[key] = PROF.get(key, 0.0) + dt

    t0 = time.time()
    results = [None] * len(segments)
    buckets: dict[int, list[int]] = {}
    for i, (q, t) in enumerate(segments):
        lq, lt = len(q), len(t)
        if lq == 0 or lt == 0 or max(lq, lt) < 16:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        S = 128
        while S < max(lq, lt):
            S *= 2
        if abs(lq - lt) >= _band_width(S) // 2 - 4 or S > 16384:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        buckets.setdefault(S, []).append(i)
    _prof("host_small", time.time() - t0)

    use_runs = nw._resolve_engine(None) == "rowscan"
    # queue every chunk's kernel before collecting any: the copies back
    # and the host decode of one chunk overlap later chunks' kernels
    in_flight = []
    for S, idxs in sorted(buckets.items()):
        W = _band_width(S)
        # reads a launch: the reference's rule on the direction scratch
        # (256 MB at one byte a cell), which the row-scan kernels' two
        # bits a cell stretch to four times the reads
        cells = (256 << 20) * (4 if use_runs else 1)
        max_b = 32
        while max_b * 2 * (2 * S + 1) * W <= cells:
            max_b *= 2
        for lo in range(0, len(idxs), max_b):
            chunk = idxs[lo : lo + max_b]
            t0 = time.time()
            B = len(chunk)
            reads = np.full((B, S), 4, dtype=np.uint8)
            drafts = np.full((B, S), 4, dtype=np.uint8)
            r_lens = np.zeros(B, dtype=np.int32)
            d_lens = np.zeros(B, dtype=np.int32)
            for k, i in enumerate(chunk):
                q, t = segments[i]
                reads[k, : len(q)] = q
                drafts[k, : len(t)] = t
                r_lens[k] = len(q)
                d_lens[k] = len(t)
            _prof("pack", time.time() - t0)
            t0 = time.time()
            if use_runs:
                dev = rsk.cigar_runs_device_raw(
                    reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
                    device=device,
                )
            else:
                # int16 on the device (S <= 16384), as the native decoder
                # takes it: half the copy of int32
                dev = nw.align_mapping_device_raw(
                    reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
                    device=device,
                )
            in_flight.append((chunk, dev, reads, drafts, r_lens, d_lens))
            _prof("dispatch", time.time() - t0)
    for chunk, dev, reads, drafts, r_lens, d_lens in in_flight:
        if not use_runs:
            _collect_mapping(chunk, dev, reads, drafts, r_lens, d_lens,
                             segments, results, _prof)
            continue
        runs_dev, nruns_dev = dev
        t0 = time.time()
        runs = runs_dev.cpu().numpy().astype(np.uint16)
        nruns = nruns_dev.cpu().numpy()
        _prof("collect_d2h", time.time() - t0)
        t0 = time.time()
        rows = native.runs_cigars_native(runs, nruns, reads, drafts, r_lens,
                                         d_lens)
        if rows is None:
            rows = [
                _decode_runs_py(runs[k], int(nruns[k]), *segments[i])
                for k, i in enumerate(chunk)
            ]
        for k, i in enumerate(chunk):
            o, l, ne = rows[k]
            if ne < 0:  # run-count overflow: realign on host
                results[i] = nw_cigar(*segments[i], match, mismatch, gap)
                _prof("n_runs_overflow", 1)
            else:
                results[i] = (o, l, ne)
        _prof("convert", time.time() - t0)
    return results


def _collect_mapping(chunk, mapping_dev, reads, drafts, r_lens, d_lens,
                     segments, results, prof):
    """Copy one chunk's int16 mapping back and decode its CIGARs."""
    t0 = time.time()
    mapping = mapping_dev.cpu().numpy()
    prof("collect_d2h", time.time() - t0)
    t0 = time.time()
    rows = native.mapping_cigars_native(mapping, reads, drafts, r_lens,
                                        d_lens)
    if rows is None:
        rows = [mapping_to_cigar(mapping[k], *segments[i])
                for k, i in enumerate(chunk)]
    for k, i in enumerate(chunk):
        results[i] = rows[k]
    prof("convert", time.time() - t0)


# --------------------------------------------------------------------------
# host half: the port's copy of haslr_tpu.aligner.extend's host functions
# --------------------------------------------------------------------------


def nw_cigar(a: np.ndarray, b: np.ndarray, match=2, mismatch=-4, gap=-2,
             band=64):
    """Banded global alignment of two code arrays; returns (ops, lens,
    n_eq).

    ``a`` plays the query (I consumes a), ``b`` the target (D consumes b).
    The band follows the main diagonal with half-width ``band`` plus the
    length difference, so it is exact whenever the optimal path drifts
    less than ``band`` off-diagonal (and fully exact when the band covers
    the whole matrix).
    """
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), 0
    if la == 0:
        return (np.array([ccigar.D], np.uint8), np.array([lb], np.int64), 0)
    if lb == 0:
        return (np.array([ccigar.I], np.uint8), np.array([la], np.int64), 0)
    W = min(lb + 1, abs(la - lb) + 2 * band + 1)
    # row i covers columns [offs[i], offs[i] + W)
    offs = np.clip(
        (np.arange(la + 1) * lb) // la - W // 2, 0, max(0, lb + 1 - W)
    )
    ks = np.arange(W, dtype=np.int64)
    H = np.empty((la + 1, W), dtype=np.int64)
    j0 = offs[0] + ks  # == ks
    H[0] = np.where(j0 <= lb, gap * j0, NEG_H)
    pad = np.full(W + 2, NEG_H, dtype=np.int64)
    for i in range(1, la + 1):
        shift = offs[i] - offs[i - 1]
        j = offs[i] + ks
        pad[1 : W + 1] = H[i - 1]
        # neighbor windows: prev index k + shift (up), k + shift - 1 (diag);
        # out-of-band indices land on the NEG_H pad cells
        up = pad[np.clip(ks + shift, -1, W) + 1]
        diag = pad[np.clip(ks + shift - 1, -1, W) + 1]
        jb = np.clip(j - 1, 0, lb - 1)
        sub = np.where(b[jb] == a[i - 1], match, mismatch)
        valid_j = (j <= lb)
        tmp = np.maximum(
            np.where(j >= 1, diag + sub, NEG_H),
            up + gap,
        )
        # in-row insertion chain within the band window
        row = gap * j + np.maximum.accumulate(tmp - gap * j)
        H[i] = np.where(valid_j, np.maximum(tmp, row), NEG_H)
    # traceback
    ops = []
    i, j = la, lb
    n_eq = 0
    while i > 0 or j > 0:
        k = j - offs[i]
        h = H[i][k]
        moved = False
        if i > 0 and j > 0:
            kp = j - 1 - offs[i - 1]
            if 0 <= kp < W and h == H[i - 1][kp] + (
                match if a[i - 1] == b[j - 1] else mismatch
            ):
                ops.append(ccigar.M)
                n_eq += int(a[i - 1] == b[j - 1])
                i -= 1
                j -= 1
                moved = True
        if not moved and i > 0:
            kp = j - offs[i - 1]
            if 0 <= kp < W and h == H[i - 1][kp] + gap:
                ops.append(ccigar.I)
                i -= 1
                moved = True
        if not moved:
            if j > 0 and (i == 0 or j - 1 - offs[i] >= 0):
                ops.append(ccigar.D)
                j -= 1
            else:
                # band edge: force the remaining moves
                ops.append(ccigar.I if i > 0 else ccigar.D)
                if i > 0:
                    i -= 1
                else:
                    j -= 1
    ops.reverse()
    o, l = ccigar.normalize(
        np.array(ops, dtype=np.uint8),
        np.ones(len(ops), dtype=np.int64),
    )
    return o, l, n_eq


def mapping_to_cigar(m: np.ndarray, q_codes: np.ndarray,
                     t_codes: np.ndarray):
    """Convert a device alignment mapping row to (ops, lens, n_eq).

    ``m[i]`` is the draft position of read base i (or ``-(a+3)`` for an
    insertion after draft position a) as produced by
    :func:`haslr_tpu_torch.kernels.nw.align_mapping_device`; the global
    alignment consumes all of both sequences.  Fully vectorized: every
    read position expands to an optional D run plus one M/I column, then
    ``cigar.normalize`` merges runs and drops zero-length ops.
    """
    L = len(q_codes)
    d_len = len(t_codes)
    if L == 0:
        if d_len == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64), 0
        return (np.array([ccigar.D], np.uint8),
                np.array([d_len], np.int64), 0)
    mm = m[:L].astype(np.int64)
    diag = mm >= 0
    j_vals = np.where(diag, mm, -1)
    prev_j = np.maximum.accumulate(np.concatenate([[-1], j_vals]))[:-1]
    d_before = np.where(diag, j_vals - prev_j - 1, 0)
    # per position: [D run][M or I]
    ops = np.empty(2 * L + 1, dtype=np.uint8)
    lens = np.empty(2 * L + 1, dtype=np.int64)
    ops[0::2][:L] = ccigar.D
    lens[0::2][:L] = d_before
    ops[1::2] = np.where(diag, ccigar.M, ccigar.I).astype(np.uint8)
    lens[1::2] = 1
    last_j = int(j_vals.max()) if diag.any() else -1
    ops[-1] = ccigar.D
    lens[-1] = d_len - 1 - last_j
    n_eq = int(
        np.sum(q_codes[diag] == t_codes[np.clip(j_vals[diag], 0, d_len - 1)])
    )
    return ccigar.normalize(ops, lens) + (n_eq,)


def _decode_runs_py(runs_row: np.ndarray, n: int, q_codes: np.ndarray,
                    t_codes: np.ndarray):
    """Pure-Python fallback for :func:`haslr_tpu_torch.native.runs_cigars_native`
    on one row: reverse the traceback-ordered packed runs, normalize, and
    count exact matches (n_eq = -1 on overflow/malformed rows)."""
    if n < 0 or n > len(runs_row):
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), -1
    v = runs_row[:n][::-1].astype(np.int64)
    ops = (v & 3).astype(np.uint8)
    lens = (v >> 2) + 1
    qpos = np.cumsum(np.where(ops != ccigar.D, lens, 0))
    tpos = np.cumsum(np.where(ops != ccigar.I, lens, 0))
    if (
        (qpos[-1] if n else 0) != len(q_codes)
        or (tpos[-1] if n else 0) != len(t_codes)
    ):
        return np.zeros(0, np.uint8), np.zeros(0, np.int64), -1
    n_eq = 0
    q0 = np.concatenate([[0], qpos[:-1]])
    t0 = np.concatenate([[0], tpos[:-1]])
    for k in np.nonzero(ops == ccigar.M)[0]:
        n_eq += int(
            np.sum(
                q_codes[q0[k] : qpos[k]] == t_codes[t0[k] : tpos[k]]
            )
        )
    return ccigar.normalize(ops, lens) + (n_eq,)


def chain_to_segments(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_anchor: np.ndarray,
    t_anchor: np.ndarray,
    k: int,
    exact_anchors: bool = True,
    coalesce: int = 256,
):
    """Decompose a chain into (literal_parts, nw_segments).

    Returns ``parts``: an ordered list of either ``("M", length, n_eq)``
    literal match runs (exact anchors / diagonal stretches) or
    ``("NW", seg_idx)`` placeholders, plus the list of (q_seg, t_seg)
    code-array pairs to align.  Shared by the single-read and batched
    extension paths.
    """
    parts = []
    segs = []
    cq, ct = int(q_anchor[0]), int(t_anchor[0])
    for q2, t2 in zip(q_anchor[1:], t_anchor[1:]):
        q2, t2 = int(q2), int(t2)
        dq, dt = q2 - cq, t2 - ct
        if dq <= 0 or dt <= 0:
            continue
        if dq == dt and exact_anchors:
            ne = int(np.sum(q_codes[cq : cq + dq] == t_codes[ct : ct + dq]))
            parts.append(("M", dq, ne))
            cq, ct = q2, t2
        elif exact_anchors:
            if dq < k or dt < k:
                continue
            parts.append(("M", k, k))
            parts.append(("NW", len(segs)))
            segs.append((q_codes[cq + k : q2], t_codes[ct + k : t2]))
            cq, ct = q2, t2
        else:
            if dq < coalesce and dt < coalesce and (q2, t2) != (
                int(q_anchor[-1]), int(t_anchor[-1])
            ):
                continue
            parts.append(("NW", len(segs)))
            segs.append((q_codes[cq:q2], t_codes[ct:t2]))
            cq, ct = q2, t2
    if exact_anchors:
        ne = int(np.sum(q_codes[cq : cq + k] == t_codes[ct : ct + k]))
        parts.append(("M", k, ne))
    else:
        qe = min(cq + k, len(q_codes))
        te = min(ct + k, len(t_codes))
        parts.append(("NW", len(segs)))
        segs.append((q_codes[cq:qe], t_codes[ct:te]))
    return parts, segs


def assemble_parts(parts, seg_results, seg_base=0):
    """Stitch literal parts + aligned segments into one normalized CIGAR.

    ``seg_base`` offsets the NW part indices into ``seg_results`` —
    callers pass the WHOLE result list plus the base instead of slicing
    it per record (``seg_results[base:]`` copies the list tail: O(n^2)
    over a mapping run, measured 2800 s of the 50 Mb e2e's emit)."""
    ops_list = []
    lens_list = []
    n_match = 0
    for part in parts:
        if part[0] == "M":
            ops_list.append(np.array([ccigar.M], np.uint8))
            lens_list.append(np.array([part[1]], np.int64))
            n_match += part[2]
        else:
            o, l, ne = seg_results[seg_base + part[1]]
            ops_list.append(o)
            lens_list.append(l)
            n_match += ne
    ops = np.concatenate(ops_list)
    lens = np.concatenate(lens_list)
    return ccigar.normalize(ops, lens) + (n_match,)


def chain_to_cigar(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_anchor: np.ndarray,
    t_anchor: np.ndarray,
    k: int,
    exact_anchors: bool = True,
):
    """CIGAR over [q_anchor[0], q_anchor[-1]+k) x [t_anchor[0], ...+k),
    aligning gap segments on host (single-read path; the batched pipeline
    in :mod:`haslr_tpu_torch.aligner.map` sends segments through the device
    kernel instead).  Returns (ops, lens, n_match)."""
    parts, segs = chain_to_segments(
        q_codes, t_codes, q_anchor, t_anchor, k, exact_anchors
    )
    seg_results = [nw_cigar(q, t) for q, t in segs]
    return assemble_parts(parts, seg_results)
