"""Minimizer index over the target contigs.

The structure-of-arrays analog of minimap2's hash-table index: all contig
minimizers are collected into flat arrays sorted by hash; lookup is a
binary search returning a slice.  The index is built once per assembly and
(in the multi-host design) replicated per host while reads stream
data-parallel (SURVEY.md §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from haslr_tpu_torch.aligner import minimizer as mz


@dataclass
class MinimizerIndex:
    k: int
    w: int
    hpc: bool
    hashes: np.ndarray      # sorted uint64
    contig_ids: np.ndarray  # int32, parallel to hashes
    positions: np.ndarray   # int64 start position on the contig
    strands: np.ndarray     # uint8
    contig_lens: np.ndarray
    max_occ: int = 50       # ignore seeds more frequent than this
    # top-16-bit bucket prefix offsets (65537 entries): narrows each
    # lookup's binary search to a cache-resident range
    bucket_start: np.ndarray | None = None

    @classmethod
    def build(cls, contig_codes: list, k: int, w: int, hpc: bool = False,
              max_occ: int = 50) -> "MinimizerIndex":
        hs, cids, ps, ss = [], [], [], []
        lens = np.array([len(c) for c in contig_codes], dtype=np.int64)
        for cid, codes in enumerate(contig_codes):
            h, p, _e, s = mz.minimizers(codes, k, w, hpc)
            hs.append(h)
            ps.append(p)
            ss.append(s)
            cids.append(np.full(len(h), cid, dtype=np.int32))
        h = np.concatenate(hs) if hs else np.zeros(0, np.uint64)
        cid = np.concatenate(cids) if cids else np.zeros(0, np.int32)
        p = np.concatenate(ps) if ps else np.zeros(0, np.int64)
        s = np.concatenate(ss) if ss else np.zeros(0, np.uint8)
        order = np.argsort(h, kind="stable")
        h = h[order]
        bstart = np.searchsorted(
            h, np.arange(1 << 16, dtype=np.uint64) << np.uint64(48),
            side="left",
        ).astype(np.uint64)
        bstart = np.concatenate([bstart, [np.uint64(len(h))]])
        return cls(k, w, hpc, h, cid[order], p[order], s[order], lens,
                   max_occ, bstart)

    def lookup(self, query_hashes: np.ndarray):
        """For each query hash: (start, end) slice into the index arrays.

        The native bucketed equal-range (chain.cpp::hx_idx_lookup)
        replaces two whole-array numpy searchsorted calls per read —
        measured ~35% of the 50 Mb seed+chain phase."""
        if self.bucket_start is not None:
            from haslr_tpu_torch import native

            out = native.idx_lookup_native(
                self.hashes, self.bucket_start, query_hashes
            )
            if out is not None:
                return out
        lo = np.searchsorted(self.hashes, query_hashes, side="left")
        hi = np.searchsorted(self.hashes, query_hashes, side="right")
        return lo, hi
