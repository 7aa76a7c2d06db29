"""K-mer count streams on the host (the port's part of
:mod:`haslr_tpu.kernels.kmer`).

So far only :func:`merge_kmer_counts`, the merge of per-shard sorted
count streams that the sharded short-read stage runs
(:func:`haslr_tpu_torch.sr.assemble_sr._count_native_sharded`); the
device counters of the reference's module are still to be ported
(ROADMAP A7).
"""

from __future__ import annotations

import numpy as np

# the largest count a merge returns: the native merge's uint32 ceiling
COUNT_MAX = 0xFFFFFFFF


def merge_kmer_counts(parts, min_count: int = 1, prefix_bits: int = 6):
    """Merge per-shard canonical k-mer count streams (the multi-host SR
    counting path).

    ``parts``: iterable of ``(hi, lo, count)`` triples, each sorted by
    ``(hi, lo)`` — the output contract of :func:`count_kmers_host` /
    ``native.count_kmers_native`` — counted at ``min_count=1`` per shard
    (a k-mer can sit below the abundance threshold in every shard and
    above it globally; filtering happens HERE, after summation).  Returns
    the merged sorted ``(hi, lo, count)`` with ``count >= min_count``.

    At pod scale each host counts its read shard natively
    (``native/kmer.cpp``, 17-32 Mbases/s/host), the sorted shard streams
    are range-split by the k-mer's high bits (one ``searchsorted`` per
    shard — the (k-mer, count) all-to-all of SURVEY §2.3), and every host
    runs this merge over its own disjoint range; concatenating the range
    outputs in prefix order yields the global sorted stream.  The range
    loop below is that per-range merge: memory is bounded by the largest
    range, not the input.  (For k <= 32 every ``hi`` is 0 and the split
    degenerates to one range — the 64-bit ``lo`` keys could be range-split
    the same way if that ever matters; production k is 49.)

    Counts are summed in int64, filtered, then saturated at
    :data:`COUNT_MAX` = 2^32 - 1, as the native merge (``hx_kmer_merge``,
    ``native/kmer.cpp``) stores them in uint32: both branches give one
    answer.  This is the one difference from the reference's function,
    whose numpy branch returns the unsaturated sums.
    """
    parts = [p for p in parts if len(p[0])]
    z = np.zeros(0, np.uint64)
    if not parts:
        return z, z, np.zeros(0, np.int64)

    if len(parts) > 1:
        # native single-pass k-way merge (each shard is already sorted;
        # the numpy path below re-sorts the concatenation)
        from haslr_tpu_torch import native

        out = native.merge_kmer_native(parts, min_count)
        if out is not None:
            return out

    def _merge_range(chunks):
        hi = np.concatenate([c[0] for c in chunks])
        lo = np.concatenate([c[1] for c in chunks])
        cnt = np.concatenate([c[2] for c in chunks])
        order = np.lexsort((lo, hi))
        hi, lo, cnt = hi[order], lo[order], cnt[order]
        new = np.empty(len(hi), bool)
        new[0] = True
        np.not_equal(hi[1:], hi[:-1], out=new[1:])
        np.logical_or(new[1:], lo[1:] != lo[:-1], out=new[1:])
        starts = np.nonzero(new)[0]
        sums = np.add.reduceat(cnt, starts)
        keep = sums >= min_count
        return hi[starts][keep], lo[starts][keep], np.minimum(
            sums[keep], COUNT_MAX
        ).astype(np.int64)

    if len(parts) == 1:
        hi, lo, cnt = parts[0]
        keep = cnt >= min_count
        return hi[keep], lo[keep], np.minimum(cnt[keep], COUNT_MAX).astype(
            np.int64
        )

    # range-split on the high bits of (hi) so peak memory is ~the largest
    # range, not the whole input; each part is sorted, so one searchsorted
    # per part finds its slice of every range
    n_ranges = 1 << prefix_bits
    k_hi_bits = max(
        int(p[0][-1]).bit_length() for p in parts
    )
    if k_hi_bits <= prefix_bits:
        return _merge_range(parts)
    shift = np.uint64(k_hi_bits - prefix_bits)
    edges = (np.arange(1, n_ranges, dtype=np.uint64) << shift)
    bounds = [
        np.concatenate(
            [[0], np.searchsorted(p[0], edges), [len(p[0])]]
        )
        for p in parts
    ]
    his, los, cnts = [], [], []
    for r in range(n_ranges):
        chunks = [
            (p[0][b[r] : b[r + 1]], p[1][b[r] : b[r + 1]],
             p[2][b[r] : b[r + 1]])
            for p, b in zip(parts, bounds)
            if b[r + 1] > b[r]
        ]
        if not chunks:
            continue
        h, l, c = _merge_range(chunks)
        his.append(h)
        los.append(l)
        cnts.append(c)
    if not his:
        return z, z, np.zeros(0, np.int64)
    return np.concatenate(his), np.concatenate(los), np.concatenate(cnts)
