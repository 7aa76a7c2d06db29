"""Device-resident pileup accumulation and voting for the chunked
window consensus (port of :mod:`haslr_tpu.kernels.pileup`).

The device twin of :class:`haslr_tpu_torch.kernels.consensus._Pileup`:
each chunk's alignment mapping is scattered into flat per-window vote
tables (base counts, coverage diff, first and second inserted base)
while it is still on the device (:func:`_scatter_chunk`), right behind
the kernel that made it (:meth:`DevicePileup.align_add_chunk`: the
row-scan ``hx_rowscan_mapping`` or the wavefront ``hx_wavefront_mapping``
through :func:`haslr_tpu_torch.kernels.nw.align_mapping_device_raw`), and
the majority vote runs there too (:func:`_vote_packed`), so only the
compact vote calls (one byte a table row) cross to the host at the end
of a polish round.

The tables are the reference's flat layout: window w's draft positions
at rows ``off[w]``.. of the base table, its D+1 insertion slots at rows
``off1[w]``.. of the insertion and coverage tables.  Masked lanes are
dropped by selection before the ``index_add_`` (exact integer sums), not
sent to a dump slot.  The reference's power-of-two table padding (stable
jit shapes) has no purpose here and is left out.
"""

from __future__ import annotations

import numpy as np
import torch

from haslr_tpu_torch.kernels import nw
from haslr_tpu_torch.kernels.consensus_dense import _best_and_sum


def _add_ones(table, idx):
    """``table.view(-1)[idx] += 1`` for every entry of ``idx``
    (repeats add up)."""
    table.view(-1).index_add_(
        0, idx, torch.ones(idx.shape[0], dtype=table.dtype,
                           device=table.device))


def _scatter_chunk(counts, cov_diff, ins1, ins2, n_reads, mapping, reads,
                   r_lens, woff, woff1, win_idx):
    """Accumulate one (B, S) chunk into the flat vote tables, in place.
    ``mapping``: the (B, S) read->draft mapping (``j`` aligned,
    ``-(a+3)`` inserted after draft position ``a``, -1 unused);
    ``woff``/``woff1``: each row's window offsets into the base and the
    insertion tables; every argument on the tables' device."""
    B, S = mapping.shape
    col = torch.arange(S, device=mapping.device)[None, :]
    in_len = col < r_lens[:, None]
    m = mapping.to(torch.int64)
    aligned = (m >= 0) & in_len
    rbase = reads.to(torch.int64) & 3
    _add_ones(counts, ((woff[:, None] + m) * 4 + rbase)[aligned])

    # coverage spans; rows with no aligned base contribute nothing
    any_aligned = aligned.any(dim=1)
    jmin = torch.where(aligned, m, 1 << 40).amin(dim=1)
    jmax = torch.where(aligned, m, -1).amax(dim=1)
    ones = torch.ones_like(jmin, dtype=cov_diff.dtype)
    cov_diff.index_add_(0, (woff1 + jmin)[any_aligned], ones[any_aligned])
    cov_diff.index_add_(0, (woff1 + jmax + 1)[any_aligned],
                        -ones[any_aligned])
    _add_ones(n_reads, win_idx[any_aligned])

    # insertions: anchor a = -m - 3, ranked within runs (per row); the
    # rank is the distance to the run's start, whose column a running
    # maximum carries along the row
    ins = (m <= -2) & in_len
    anchors = -m - 3
    prev_ins = torch.cat([torch.zeros_like(ins[:, :1]), ins[:, :-1]], 1)
    prev_anchor = torch.cat([torch.full_like(anchors[:, :1], -9),
                             anchors[:, :-1]], 1)
    start = ins & (~prev_ins | (anchors != prev_anchor))
    idx = col.expand(B, S)
    last_start = torch.cummax(torch.where(start, idx, -1), dim=1).values
    rank = idx - last_start
    row_ok = any_aligned[:, None]
    slot = (woff1[:, None] + anchors + 1) * 4 + rbase
    _add_ones(ins1, slot[ins & (rank == 0) & row_ok])
    _add_ones(ins2, slot[ins & (rank == 1) & row_ok])


def _vote_packed(counts, cov_diff, ins1, ins2, draft_flat, d_lens):
    """Majority vote on the device; returns ONE packed uint8 tensor (call
    in bits 0-1, emit flag in bit 2) laid out as ``[base rows | ins1 rows
    | ins2 rows]``, one copy to the host a polish round.  Emit rules and
    tie-breaks are the host ``_Pileup.vote``'s: lowest-index argmax, the
    draft base on a tie with the best.

    Index identities (``off1[w] = off[w] + w``): base row r of window w
    sits at coverage index ``r + w``; insertion row r1 at position
    ``pos1`` of its window reads the coverage at ``r1 - (pos1 > 0)``."""
    dev = counts.device
    n_win = d_lens.shape[0]
    wins = torch.arange(n_win, device=dev)
    coverage = torch.cumsum(cov_diff, 0)
    base_best, base_best_cnt, base_sum = _best_and_sum(counts)
    draft = draft_flat.to(torch.int64)
    draft_cnt = counts.gather(1, draft[:, None])[:, 0]
    base_call = torch.where(draft_cnt == base_best_cnt, draft, base_best)
    win = torch.repeat_interleave(wins, d_lens)
    base_cov = coverage[torch.arange(win.shape[0], device=dev) + win]
    emit_base = base_best_cnt > base_cov - base_sum

    win1 = torch.repeat_interleave(wins, d_lens + 1)
    rows1 = torch.arange(win1.shape[0], device=dev)
    off1 = torch.cumsum(d_lens + 1, 0) - (d_lens + 1)
    pos1 = rows1 - off1[win1]
    cov_prev = coverage[rows1 - (pos1 > 0).to(torch.int64)].clamp(min=1)
    ins1_call, _, ins1_sum = _best_and_sum(ins1)
    ins2_call, _, ins2_sum = _best_and_sum(ins2)
    emit_i1 = ins1_sum * 2 > cov_prev
    emit_i2 = (ins2_sum * 2 > cov_prev) & emit_i1
    return torch.cat([
        base_call | (emit_base.to(torch.int64) << 2),
        ins1_call | (emit_i1.to(torch.int64) << 2),
        ins2_call | (emit_i2.to(torch.int64) << 2),
    ]).to(torch.uint8)


class DevicePileup:
    """Same contract as the host ``_Pileup``, with the tables on
    ``device``: the mapping tensors stay there end to end."""

    def __init__(self, drafts, device):
        self.device = device
        self.d_lens = np.array([len(d) for d in drafts], dtype=np.int64)
        self.off = np.concatenate([[0], np.cumsum(self.d_lens)])
        self.off1 = np.concatenate([[0], np.cumsum(self.d_lens + 1)])
        total = int(self.off[-1])
        total1 = int(self.off1[-1])

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        self.counts = zeros(total, 4)
        # a read's span ends at most at its window's last slot, so the
        # diff needs no row past total1
        self.cov_diff = zeros(total1)
        self.ins1 = zeros(total1, 4)
        self.ins2 = zeros(total1, 4)
        self.n_reads = zeros(len(drafts))

    def _put(self, a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def add_chunk_device(self, mapping_dev, reads, r_lens, win_idx):
        """Scatter a mapping already on the device (host reads, lengths
        and window ids)."""
        _scatter_chunk(
            self.counts, self.cov_diff, self.ins1, self.ins2, self.n_reads,
            mapping_dev, self._put(reads, np.uint8),
            self._put(r_lens, np.int64),
            self._put(self.off[win_idx], np.int64),
            self._put(self.off1[win_idx], np.int64),
            self._put(win_idx, np.int64),
        )

    def align_add_chunk(self, reads, r_lens, drafts, d_lens, win_idx, W,
                        match, mismatch, gap):
        """Align the chunk with the active NW engine's mapping kernel and
        scatter its mapping, which never leaves the device."""
        mapping = nw.align_mapping_device_raw(
            reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
            device=self.device,
        )
        self.add_chunk_device(mapping, reads, r_lens, win_idx)

    def vote(self, drafts):
        """Packed single-transfer vote (see :func:`_vote_packed`)."""
        n_win = len(drafts)
        if n_win == 0:
            return []
        draft_flat = np.concatenate(drafts) if self.off[-1] \
            else np.zeros(0, np.uint8)
        packed = _vote_packed(
            self.counts, self.cov_diff, self.ins1, self.ins2,
            self._put(draft_flat, np.uint8), self._put(self.d_lens,
                                                       np.int64),
        ).cpu().numpy()
        total = int(self.off[-1])
        total1 = int(self.off1[-1])
        base = packed[:total]
        i1 = packed[total : total + total1]
        i2 = packed[total + total1 :]
        base_call, emit_base = base & 3, (base & 4) != 0
        ins1_call, emit_i1 = i1 & 3, (i1 & 4) != 0
        ins2_call, emit_i2 = i2 & 3, (i2 & 4) != 0
        n_reads = self.n_reads.cpu().numpy()
        results = []
        for w, d in enumerate(drafts):
            if n_reads[w] == 0:
                results.append(d)
                continue
            Dw = len(d)
            b0, b1 = self.off[w], self.off[w + 1]
            i0, i1_ = self.off1[w], self.off1[w + 1]
            vals = np.empty(2 + 3 * Dw, dtype=np.uint8)
            keep = np.zeros(2 + 3 * Dw, dtype=bool)
            vals[0] = ins1_call[i0]
            keep[0] = emit_i1[i0]
            vals[1] = ins2_call[i0]
            keep[1] = emit_i2[i0]
            vals[2::3] = base_call[b0:b1]
            keep[2::3] = emit_base[b0:b1]
            vals[3::3] = ins1_call[i0 + 1 : i1_]
            keep[3::3] = emit_i1[i0 + 1 : i1_]
            vals[4::3] = ins2_call[i0 + 1 : i1_]
            keep[4::3] = emit_i2[i0 + 1 : i1_]
            results.append(vals[keep])
        return results
