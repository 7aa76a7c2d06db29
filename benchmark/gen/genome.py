"""A random genome of several replicons with interspersed exact repeats.

Repeats are what break a de Bruijn assembly into contigs, and what the
long reads bridge.  Copies of a family are exact (the hardest case for
the assembler's uniqueness filters), never overlap one another, and are
planted in either orientation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of 2-bit codes (0-3 = ACGT)."""
    return (3 - codes[::-1]).astype(np.uint8)


@dataclass
class Genome:
    codes: np.ndarray        # uint8 (G,), the replicons concatenated
    rep_off: np.ndarray      # int64 (n_replicons + 1,) offsets into codes
    fam_seqs: list           # uint8 array per repeat family
    copy_fam: np.ndarray     # int64 (C,) family of each planted copy
    copy_start: np.ndarray   # int64 (C,) global start, sorted
    copy_len: np.ndarray     # int64 (C,)
    copy_rev: np.ndarray     # bool (C,) planted as the family's revcomp

    @property
    def length(self) -> int:
        return int(self.rep_off[-1])


def make_genome(rng: np.random.Generator, replicon_lengths, families,
                min_gap: int) -> Genome:
    """``families``: ``[(n_families, copies_each, length), ...]``.  Every
    copy lands in a replicon chosen by length, at least ``min_gap`` bases
    from its neighbours and from the replicon's ends."""
    lengths = np.asarray(replicon_lengths, np.int64)
    rep_off = np.concatenate([[0], np.cumsum(lengths)])
    codes = rng.integers(0, 4, int(rep_off[-1]), dtype=np.uint8)
    fam_seqs, fam_copies = [], []
    for n_fam, copies, length in families:
        for _ in range(n_fam):
            fam_seqs.append(rng.integers(0, 4, length, dtype=np.uint8))
            fam_copies.append(copies)
    copy_fam = np.repeat(np.arange(len(fam_seqs)), fam_copies)
    copy_fam = copy_fam[rng.permutation(len(copy_fam))]
    copy_len = np.array([len(fam_seqs[f]) for f in copy_fam], np.int64)
    copy_rev = rng.random(len(copy_fam)) < 0.5
    rep_of = rng.choice(len(lengths), len(copy_fam),
                        p=lengths / lengths.sum())
    copy_start = np.zeros(len(copy_fam), np.int64)
    for r in range(len(lengths)):
        sel = np.nonzero(rep_of == r)[0]
        free = lengths[r] - copy_len[sel].sum() - (len(sel) + 1) * min_gap
        if free < 0:
            raise ValueError(f"replicon {r} cannot hold its {len(sel)} "
                             "repeat copies")
        cuts = np.sort(rng.integers(0, free + 1, len(sel)))
        gaps = np.diff(np.concatenate([[0], cuts])) + min_gap
        copy_start[sel] = (rep_off[r] + np.cumsum(gaps)
                           + np.concatenate([[0], np.cumsum(copy_len[sel])[:-1]]))
    for c in range(len(copy_fam)):
        seq = fam_seqs[copy_fam[c]]
        s = int(copy_start[c])
        codes[s : s + len(seq)] = revcomp(seq) if copy_rev[c] else seq
    order = np.argsort(copy_start)
    return Genome(codes, rep_off, fam_seqs, copy_fam[order],
                  copy_start[order], copy_len[order], copy_rev[order])
