"""Noisy long reads with their edit operations, vectorised.

Every template base draws one number: below e/3 it is deleted, below
2e/3 substituted (by one of the three other bases), below e kept with a
random base inserted after it; otherwise it is kept.  The reads are
drawn in blocks of templates so that no array grows with the read set;
the block size is fixed, so a seed gives the same bytes on any host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MATCH, SUB, DEL = 0, 1, 2
BLOCK_BASES = 1 << 24   # template bases mutated at once


@dataclass
class LongReads:
    seq: np.ndarray         # uint8, every read as sequenced, concatenated
    seq_off: np.ndarray     # int64 (n + 1,)
    tpl_start: np.ndarray   # int64 (n,) global genome start of the template
    tpl_off: np.ndarray     # int64 (n + 1,) offsets into kind / ins
    strand: np.ndarray      # bool (n,) read is the template's revcomp
    kind: np.ndarray        # uint8 (T,) MATCH / SUB / DEL a template base
    ins: np.ndarray         # bool (T,) a base inserted after it

    def __len__(self) -> int:
        return len(self.tpl_start)

    @property
    def n_bases(self) -> int:
        return int(self.seq_off[-1])


def draw_layout(rng, rep_off, raw_coverage, len_mean, len_sd, len_min,
                len_max, cov_lr, genome_size):
    """Template starts, lengths and strands of the reads that the
    pipeline's ``--cov-lr`` keeps: a raw set of log-normal lengths (mean
    ``len_mean``, sd ``len_sd``, clipped to ``[len_min, len_max]``) drawn until it
    reaches ``raw_coverage`` times the genome, of which the longest
    totalling ``cov_lr`` times ``genome_size`` (the read that crosses
    the budget kept), longest first, as ``fastutils subsample`` writes
    them.  Each read lies inside one replicon, chosen by length."""
    lens_rep = np.diff(rep_off)
    G = int(rep_off[-1])
    s2 = np.log1p((len_sd / len_mean) ** 2)
    n_draw = int(raw_coverage * G / len_mean * 1.2) + 64
    lens = np.rint(rng.lognormal(np.log(len_mean) - s2 / 2, np.sqrt(s2),
                                 n_draw)).astype(np.int64)
    lens = np.clip(lens, len_min, min(len_max, lens_rep.max()))
    lens = lens[: int(np.searchsorted(np.cumsum(lens),
                                      raw_coverage * G)) + 1]
    lens = -np.sort(-lens)
    n = int(np.searchsorted(np.cumsum(lens), cov_lr * genome_size)) + 1
    lens = lens[:n]
    rep = rng.choice(len(lens_rep), len(lens), p=lens_rep / G)
    lens = np.minimum(lens, lens_rep[rep])
    local = (rng.random(len(lens)) * (lens_rep[rep] - lens + 1)).astype(
        np.int64)
    strand = rng.random(len(lens)) < 0.5
    return rep_off[rep] + local, lens, strand


def _mutate(rng, tpl, error_rate):
    """(read codes, kind, ins, per-base output counts) of one block."""
    third = error_rate / 3
    r = rng.random(len(tpl))
    kind = np.full(len(tpl), MATCH, np.uint8)
    kind[r < third] = DEL
    sub = (r >= third) & (r < 2 * third)
    kind[sub] = SUB
    ins = (r >= 2 * third) & (r < error_rate)
    base = tpl.copy()
    base[sub] = (base[sub] + 1 + rng.integers(0, 3, int(sub.sum()),
                                              dtype=np.uint8)) % 4
    keep = kind != DEL
    n_out = keep.astype(np.int64) + ins
    pos = np.cumsum(n_out) - n_out
    out = np.empty(int(n_out.sum()), np.uint8)
    out[pos[keep]] = base[keep]
    out[pos[ins] + keep[ins]] = rng.integers(0, 4, int(ins.sum()),
                                             dtype=np.uint8)
    return out, kind, ins, n_out


def make_long_reads(rng, genome_codes, rep_off, lc: dict) -> LongReads:
    """The reads of a configuration's ``long_reads`` (``error_rate`` and
    the parameters of :func:`draw_layout`)."""
    starts, lens, strand = draw_layout(
        rng, rep_off, lc["raw_coverage"], lc["len_mean"], lc["len_sd"],
        lc["len_min"], lc["len_max"], lc["cov_lr"], lc["genome_size"])
    error_rate = lc["error_rate"]
    tpl_off = np.concatenate([[0], np.cumsum(lens)])
    seqs, kinds, inss, read_lens = [], [], [], []
    a = 0
    while a < len(lens):
        b = int(np.searchsorted(tpl_off, tpl_off[a] + BLOCK_BASES,
                                side="right")) - 1
        b = max(b, a + 1)
        blen = lens[a:b]
        idx = np.repeat(starts[a:b] - (tpl_off[a:b] - tpl_off[a]), blen) \
            + np.arange(int(blen.sum()))
        out, kind, ins, n_out = _mutate(rng, genome_codes[idx], error_rate)
        rl = np.add.reduceat(n_out, (tpl_off[a:b] - tpl_off[a]))
        ro = np.concatenate([[0], np.cumsum(rl)])
        # reads of the reverse strand: reverse and complement in place
        rev = np.repeat(strand[a:b], rl)
        rid = np.repeat(np.arange(b - a), rl)
        p = np.arange(len(out))
        src = np.where(rev, ro[rid] + ro[rid + 1] - 1 - p, p)
        out = out[src]
        out[rev] = 3 - out[rev]
        seqs.append(out)
        kinds.append(kind)
        inss.append(ins)
        read_lens.append(rl)
        a = b
    read_lens = np.concatenate(read_lens)
    return LongReads(
        np.concatenate(seqs), np.concatenate([[0], np.cumsum(read_lens)]),
        starts, tpl_off, strand, np.concatenate(kinds), np.concatenate(inss),
    )
