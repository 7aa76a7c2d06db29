"""Batched window consensus (port of :mod:`haslr_tpu.kernels.consensus`).

The device-batched replacement for per-window SPOA (reference
``Assemble.cpp:479-560``), with the reference's two engines, which give
the same output:

- ``engine="dense"`` (the default, the production path): the whole
  multi-round consensus per length bucket on the device, or over a
  ``dp`` mesh (:mod:`haslr_tpu_torch.kernels.consensus_dense`);
- ``engine="chunked"``: one align + vote round at a time
  (:func:`_one_round`), with a hop to the host between rounds.  Each
  window's draft starts as its median-length read; every (read, draft)
  pair is bucketed by the draft's length and aligned by the active NW
  engine's mapping kernel (:func:`haslr_tpu_torch.kernels.nw.
  align_mapping_device_raw`: ``hx_rowscan_mapping`` under ``"rowscan"``,
  ``hx_wavefront_mapping`` under ``"wavefront"``), and the mappings are
  voted in a pileup on the device (:class:`~haslr_tpu_torch.kernels.
  pileup.DevicePileup`) or, with ``device_pileup=False``, on the host
  (:class:`_Pileup`, the reference's numpy accumulator, copied).

Reads whose length differs from the draft's by more than ~W/2 cannot be
banded and are skipped.  Left out of the port: the power-of-two batch
padding of the chunked engine (stable TPU jit shapes; pad rows vote
nothing) and the Pallas switch ``nw.use_pallas_for``.
"""

from __future__ import annotations

import numpy as np
import torch

from haslr_tpu_torch import trace
from haslr_tpu_torch.core import seq as cseq
from haslr_tpu_torch.dist.mesh import Mesh, as_mesh
from haslr_tpu_torch.kernels import nw
from haslr_tpu_torch.kernels.consensus_dense import dense_consensus

ENGINES = ("dense", "chunked")

BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _bucket_size(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def _band_width(S: int) -> int:
    if S <= 1024:
        return 128
    if S <= 2048:
        return 256
    return 512


class _Pileup:
    """Batched pileup accumulator over all windows at once.

    Per-window count tables live concatenated in flat arrays indexed by
    per-window draft offsets, so every scatter is one ``np.add.at`` over a
    whole (B, S) chunk — no per-window or per-read Python loops.
    """

    def __init__(self, drafts: list[np.ndarray]):
        self.d_lens = np.array([len(d) for d in drafts], dtype=np.int64)
        # offsets into the base-count table (D per window) and the
        # insertion/coverage tables (D+1 per window)
        self.off = np.concatenate([[0], np.cumsum(self.d_lens)])
        self.off1 = np.concatenate([[0], np.cumsum(self.d_lens + 1)])
        total = int(self.off[-1])
        total1 = int(self.off1[-1])
        self.counts = np.zeros((total, 4), dtype=np.int32)
        self.cov_diff = np.zeros(total1 + 1, dtype=np.int32)
        self.ins1 = np.zeros((total1, 4), dtype=np.int32)
        self.ins2 = np.zeros((total1, 4), dtype=np.int32)
        self.n_reads = np.zeros(len(drafts), dtype=np.int64)

    def add_chunk(self, mapping: np.ndarray, reads: np.ndarray,
                  r_lens: np.ndarray, win_idx: np.ndarray):
        """mapping/reads: (B, S) arrays; win_idx: window id per row."""
        B, S = mapping.shape
        col = np.arange(S)[None, :]
        in_len = col < r_lens[:, None]
        aligned = (mapping >= 0) & in_len
        m64 = mapping.astype(np.int64)
        woff = self.off[win_idx][:, None]
        woff1 = self.off1[win_idx][:, None]
        # base votes
        np.add.at(
            self.counts,
            ((woff + m64)[aligned], reads[aligned].astype(np.int64)),
            1,
        )
        # coverage spans (rows with no aligned base contribute nothing)
        any_aligned = aligned.any(axis=1)
        big = np.where(aligned, m64, np.int64(1 << 40))
        small = np.where(aligned, m64, np.int64(-1))
        jmin = big.min(axis=1)[any_aligned]
        jmax = small.max(axis=1)[any_aligned]
        w1 = self.off1[win_idx[any_aligned]]
        np.add.at(self.cov_diff, w1 + jmin, 1)
        np.add.at(self.cov_diff, w1 + jmax + 1, -1)
        np.add.at(self.n_reads, win_idx[any_aligned], 1)
        # insertions: anchor a = -m - 3, ranked within runs (per row)
        ins = (mapping <= -2) & in_len
        anchors = (-m64 - 3)
        prev_ins = np.concatenate(
            [np.zeros((B, 1), bool), ins[:, :-1]], axis=1
        )
        prev_anchor = np.concatenate(
            [np.full((B, 1), -9, np.int64), anchors[:, :-1]], axis=1
        )
        start = ins & (~prev_ins | (anchors != prev_anchor))
        idx = np.broadcast_to(col, (B, S))
        last_start = np.maximum.accumulate(np.where(start, idx, -1), axis=1)
        rank = idx - last_start
        row_ok = any_aligned[:, None]
        sel1 = ins & (rank == 0) & row_ok
        sel2 = ins & (rank == 1) & row_ok
        np.add.at(
            self.ins1,
            ((woff1 + anchors + 1)[sel1], reads[sel1].astype(np.int64)),
            1,
        )
        np.add.at(
            self.ins2,
            ((woff1 + anchors + 1)[sel2], reads[sel2].astype(np.int64)),
            1,
        )

    def vote(self, drafts: list[np.ndarray]) -> list[np.ndarray]:
        """Emit the voted consensus per window (vectorized)."""
        draft_flat = (
            np.concatenate(drafts) if drafts else np.zeros(0, np.uint8)
        )
        total = len(draft_flat)
        coverage = np.cumsum(self.cov_diff[:-1])  # over off1 layout
        base_sum = self.counts.sum(axis=1)
        base_best = self.counts.argmax(axis=1)
        rows = np.arange(total)
        base_best_cnt = self.counts[rows, base_best]
        draft_cnt = self.counts[rows, draft_flat]
        base_call = np.where(
            draft_cnt == base_best_cnt, draft_flat, base_best
        ).astype(np.uint8)
        # per-position coverage: position p of window w is coverage at
        # off1[w] + p (cumsum over the diff array within the window)
        pos_in_win = rows - np.repeat(self.off[:-1], np.diff(self.off))
        win_of_row = np.repeat(
            np.arange(len(self.d_lens)), np.diff(self.off)
        )
        cov_at_base = coverage[self.off1[win_of_row] + pos_in_win]
        emit_base = base_best_cnt > (cov_at_base - base_sum)

        ins1_sum = self.ins1.sum(axis=1)
        ins2_sum = self.ins2.sum(axis=1)
        # coverage "before" slot a+1 mirrors the original per-window rule
        rows1 = np.arange(len(ins1_sum))
        pos1 = rows1 - np.repeat(self.off1[:-1], np.diff(self.off1))
        win1 = np.repeat(np.arange(len(self.d_lens)), np.diff(self.off1))
        cov_prev = coverage[self.off1[win1] + np.maximum(pos1 - 1, 0)]
        emit_ins1 = ins1_sum * 2 > np.maximum(cov_prev, 1)
        emit_ins2 = (ins2_sum * 2 > np.maximum(cov_prev, 1)) & emit_ins1
        ins1_best = self.ins1.argmax(axis=1).astype(np.uint8)
        ins2_best = self.ins2.argmax(axis=1).astype(np.uint8)

        out = []
        for w, d in enumerate(drafts):
            if self.n_reads[w] == 0:
                out.append(d)
                continue
            Dw = len(d)
            b0, b1 = self.off[w], self.off[w + 1]
            i0, i1 = self.off1[w], self.off1[w + 1]
            # slot order per window: ins1[0], ins2[0], then for each p:
            # base[p], ins1[p+1], ins2[p+1]
            vals = np.empty(2 + 3 * Dw, dtype=np.uint8)
            keep = np.zeros(2 + 3 * Dw, dtype=bool)
            vals[0] = ins1_best[i0]
            keep[0] = emit_ins1[i0]
            vals[1] = ins2_best[i0]
            keep[1] = emit_ins2[i0]
            vals[2::3] = base_call[b0:b1]
            keep[2::3] = emit_base[b0:b1]
            vals[3::3] = ins1_best[i0 + 1 : i1]
            keep[3::3] = emit_ins1[i0 + 1 : i1]
            vals[4::3] = ins2_best[i0 + 1 : i1]
            keep[4::3] = emit_ins2[i0 + 1 : i1]
            out.append(vals[keep])
        return out


def _one_round(window_codes, drafts, match, mismatch, gap,
               device_pileup=True, device=None):
    """One align+vote polish round for all windows on ``device``;
    returns new drafts.

    ``device_pileup`` keeps the vote tables and mapping on the device
    (the host accumulator remains as the reference implementation)."""
    # bucket (win, read) pairs
    jobs = {}  # (S) -> list of (win_idx, read_idx)
    for wi, (codes_list, draft) in enumerate(zip(window_codes, drafts)):
        if len(codes_list) <= 1 or len(draft) == 0:
            continue
        # bucket on the draft length alone: band-incompatible outlier reads
        # (e.g. whole-suffix artifacts) are dropped, not allowed to inflate
        # the padded problem size for the whole window
        S0 = _bucket_size(len(draft))
        W = _band_width(S0)
        S = _bucket_size(len(draft) + W // 2)
        W = _band_width(S)
        for ri, c in enumerate(codes_list):
            if abs(len(c) - len(draft)) >= W // 2 - 4:
                continue  # cannot band; outlier
            if len(c) == 0 or len(c) > S:
                continue
            jobs.setdefault(S, []).append((wi, ri))
    if device_pileup:
        from haslr_tpu_torch.kernels.pileup import DevicePileup

        pile = DevicePileup(drafts, device)
    else:
        pile = _Pileup(drafts)
    for S, pairs in sorted(jobs.items()):
        W = _band_width(S)
        # the reference's batch cap (512 MiB of a direction tensor); here
        # it bounds the (B, S) temporaries of the mapping and the scatter
        max_b = max(1, (512 << 20) // ((2 * S + 1) * W))
        for lo in range(0, len(pairs), max_b):
            chunk = pairs[lo : lo + max_b]
            B = len(chunk)
            reads = np.full((B, S), 4, dtype=np.uint8)
            dr = np.full((B, S), 4, dtype=np.uint8)
            r_lens = np.zeros(B, dtype=np.int32)
            d_lens = np.zeros(B, dtype=np.int32)
            win_idx = np.zeros(B, dtype=np.int64)
            for k, (wi, ri) in enumerate(chunk):
                c = window_codes[wi][ri]
                d = drafts[wi]
                reads[k, : len(c)] = c
                dr[k, : len(d)] = d
                r_lens[k] = len(c)
                d_lens[k] = len(d)
                win_idx[k] = wi
            if device_pileup:
                # the mapping never leaves the device
                pile.align_add_chunk(reads, r_lens, dr, d_lens, win_idx, W,
                                     match, mismatch, gap)
            else:
                mapping = nw.align_mapping_device(
                    reads, r_lens, dr, d_lens, W, match, mismatch, gap,
                    device=device,
                )
                pile.add_chunk(mapping, reads, r_lens, win_idx)
    return pile.vote(drafts)


def batched_consensus(
    windows: list[list[str]],
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
    rounds: int = 2,
    device_pileup: bool = True,
    engine: str = "dense",
    warn=None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> list[str]:
    """Consensus string per window (a list of supporting subsequences).

    ``engine="dense"`` polishes on ``device`` (the card unless the
    caller says ``"cpu"``) or, given a ``dp`` ``mesh``, with the reads
    split over its devices and the same output; ``warn`` takes its
    cap/drop/split notices.  ``engine="chunked"`` runs round by round on
    ``device``, or on the mesh's first device when only a mesh is given:
    like the reference's, it does not shard; ``device_pileup=False``
    votes on the host.  Both engines give the same output.  Spans
    ``consensus.encode`` (the windows' strings to codes) and
    ``consensus.decode`` (the drafts back to strings)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown consensus engine {engine!r} (one of "
                         f"{ENGINES})")
    with trace.span("consensus.encode"):
        window_codes = [
            [cseq.encode(s) for s in seqs if len(s) > 0] for seqs in windows
        ]
    if engine == "dense":
        drafts = dense_consensus(window_codes, match, mismatch, gap, rounds,
                                 warn=warn, device=device, mesh=mesh)
        return _decode(drafts)
    dev = as_mesh(device, mesh).devices[0]
    drafts = []
    for codes in window_codes:
        if not codes:
            drafts.append(np.zeros(0, dtype=np.uint8))
        else:
            by_len = sorted(codes, key=len)
            drafts.append(by_len[len(by_len) // 2])
    for _ in range(rounds):
        drafts = _one_round(window_codes, drafts, match, mismatch, gap,
                            device_pileup=device_pileup, device=dev)
    return _decode(drafts)


def _decode(drafts) -> list[str]:
    """The drafts' codes as strings (span ``consensus.decode``)."""
    with trace.span("consensus.decode"):
        return [cseq.decode(d) for d in drafts]
