"""Canonical k-mer counting on a torch device (port of
:mod:`haslr_tpu.kernels.kmer`).

The counting core of the minia replacement (reference pipeline stage
``minia -kmer-size 49 -abundance-min 3``, ``bin/haslr.py:180``): every
k-mer of a read stream is packed, canonicalized against its reverse
complement, sorted and run-length counted, then abundance-filtered.

- :func:`count_kmers_host` (with :data:`SEP`, :func:`_pack_pair_np`,
  :func:`_revcomp_pair_np`): the reference's numpy counter, copied.
- :func:`count_kmers_device`: the same contract on a torch device, in
  plain PyTorch ops (the reference's is XLA, no Pallas kernel).  A
  k-mer is held as int64 words of at most :data:`WORD_BASES` = 31 bases
  (62 bits), so the signed order of a word is its base order and no
  unsigned type is needed; rows are sorted by stable sorts from the last
  word to the first, and invalid k-mers (those across a separator or a
  read boundary) are dropped before the sort instead of being sorted
  last under a sentinel.  :func:`_words_to_pair` gives the host's
  ``(hi, lo)`` uint64 pair back.
- :func:`merge_kmer_counts`: the merge of per-shard sorted count
  streams that the sharded short-read stage runs
  (:func:`haslr_tpu_torch.sr.assemble_sr._count_native_sharded`).

The streaming counter (:mod:`haslr_tpu_torch.kernels.kmer_stream`)
builds on :func:`_canonical_words`, :func:`_sort_rows`,
:func:`_run_counts` and :func:`_words_to_pair`.
"""

from __future__ import annotations

import numpy as np
import torch

SEP = 4  # separator code between concatenated reads


def _pack_pair_np(codes: np.ndarray, k: int):
    """All k-mer (hi, lo) uint64 pairs + validity mask (numpy)."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    m = n - k + 1
    hi = np.zeros(m, np.uint64)
    lo = np.zeros(m, np.uint64)
    c = codes.astype(np.uint64)
    k_lo = min(k, 32)
    k_hi = k - k_lo
    for j in range(k_hi):
        hi = (hi << np.uint64(2)) | (c[j : m + j] & np.uint64(3))
    for j in range(k_hi, k):
        lo = (lo << np.uint64(2)) | (c[j : m + j] & np.uint64(3))
    bad = (codes >= SEP).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return hi, lo, valid


def _revcomp_pair_np(hi, lo, k):
    """Reverse complement of (hi, lo) packed k-mers.

    The original stream is hi-bases (first k-k_lo) then lo-bases (last
    k_lo); the reverse complement emits complemented bases in reverse
    order, so collecting 2-bit groups lo-first/LSB-first yields the new
    stream front-to-back: the first ``k_hi`` collected groups refill rhi,
    the rest rlo.
    """
    k_lo = min(k, 32)
    k_hi = k - k_lo
    vals = []
    x = (~lo).copy()
    for _ in range(k_lo):
        vals.append(x & np.uint64(3))
        x >>= np.uint64(2)
    x = (~hi).copy()
    for _ in range(k_hi):
        vals.append(x & np.uint64(3))
        x >>= np.uint64(2)
    rhi = np.zeros_like(hi)
    for v in vals[:k_hi]:
        rhi = (rhi << np.uint64(2)) | v
    rlo = np.zeros_like(lo)
    for v in vals[k_hi:]:
        rlo = (rlo << np.uint64(2)) | v
    return rhi, rlo


def count_kmers_host(codes: np.ndarray, k: int, min_count: int = 1):
    """Canonical k-mer counts (numpy).  ``codes`` may contain SEP=4
    separators between reads.  Returns (hi, lo, count) sorted."""
    hi, lo, valid = _pack_pair_np(codes, k)
    hi, lo = hi[valid], lo[valid]
    rhi, rlo = _revcomp_pair_np(hi, lo, k)
    use_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    chi = np.where(use_rc, rhi, hi)
    clo = np.where(use_rc, rlo, lo)
    order = np.lexsort((clo, chi))
    chi, clo = chi[order], clo[order]
    if len(chi) == 0:
        return chi, clo, np.zeros(0, np.int64)
    new = np.concatenate(
        [[True], (chi[1:] != chi[:-1]) | (clo[1:] != clo[:-1])]
    )
    starts = np.nonzero(new)[0]
    counts = np.diff(np.concatenate([starts, [len(chi)]]))
    keep = counts >= min_count
    return chi[starts][keep], clo[starts][keep], counts[keep]


# bases a word: 2 bits each, 62 of the int64's 63 value bits
WORD_BASES = 31


def _word_spans(k: int):
    """Split k bases into words of at most :data:`WORD_BASES` bases."""
    return [(s, min(s + WORD_BASES, k)) for s in range(0, k, WORD_BASES)]


def _check_k(k: int):
    # the (hi, lo) pair holds 2k <= 128 bits, as count_kmers_host does
    if not 1 <= k <= 64:
        raise ValueError(f"k must be in 1..64, got {k}")


def _canonical_words(codes: torch.Tensor, k: int, valid: torch.Tensor):
    """Canonical word columns (int64, one tensor a word of
    :func:`_word_spans`) of the k-mers that start where ``valid`` is
    set.  ``codes``: (n,) uint8 codes on the device; ``valid``: (n-k+1,)
    bool.  Only the low two bits of a code are read, so a separator
    inside an invalid k-mer does no harm."""
    m = valid.shape[0]
    fwd_codes = codes.to(torch.int64) & 3
    rc_codes = 3 - fwd_codes
    canon = []
    use_rc = torch.zeros(m, dtype=torch.bool, device=codes.device)
    undecided = torch.ones_like(use_rc)
    for b0, b1 in _word_spans(k):
        w = torch.zeros(m, dtype=torch.int64, device=codes.device)
        rw = torch.zeros_like(w)
        for j in range(b0, b1):
            w.bitwise_left_shift_(2).bitwise_or_(fwd_codes[j : j + m])
            # base j of the reverse complement is the complement of base
            # k-1-j of the k-mer
            jr = k - 1 - j
            rw.bitwise_left_shift_(2).bitwise_or_(rc_codes[jr : jr + m])
        # canonical = lexicographic min(forward, reverse complement)
        use_rc |= undecided & (rw < w)
        undecided &= rw == w
        canon.append((w, rw))
    del fwd_codes, rc_codes, undecided  # freed before the selections
    return [torch.where(use_rc, rw, w)[valid] for w, rw in canon]


def _sort_rows(words, *payload):
    """Rows in ascending order of their word columns (the first word
    most significant), by stable sorts from the last word to the first;
    ``payload`` columns follow their rows.  Returns (words, payload)."""
    order = torch.argsort(words[-1], stable=True)
    for w in reversed(words[:-1]):
        order = order[torch.argsort(w[order], stable=True)]
    return [w[order] for w in words], [p[order] for p in payload]


def _run_counts(words, min_count: int, weights=None):
    """Run-length count of sorted word rows: the distinct rows and their
    int64 counts (the run's length, or the sum of its ``weights``) where
    the count is at least ``min_count``."""
    n = words[0].shape[0]
    if n == 0:
        return list(words), torch.zeros(0, dtype=torch.int64,
                                        device=words[0].device)
    new = torch.zeros(n, dtype=torch.bool, device=words[0].device)
    new[0] = True
    for w in words:
        new[1:] |= w[1:] != w[:-1]
    starts = torch.nonzero(new).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    if weights is None:
        counts = ends - starts
    else:
        # exact: int64 prefix sums of integer weights
        csum = torch.cat([weights.new_zeros(1),
                          torch.cumsum(weights.to(torch.int64), 0)])
        counts = csum[ends] - csum[starts]
    keep = counts >= min_count
    starts = starts[keep]
    return [w[starts] for w in words], counts[keep]


def _words_to_pair(words: list, k: int):
    """Recombine int64 word columns (numpy) into the host (hi, lo) uint64
    pair: the 2k-bit k-mer's low 64 bits and the bits above them."""
    _check_k(k)
    n = len(words[0])
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for w, (b0, b1) in zip(words, _word_spans(k)):
        w = w.astype(np.uint64)
        s = 2 * (k - b1)  # bits of the bases after this word
        if s < 64:
            lo |= w << np.uint64(s)
        if s + 2 * (b1 - b0) > 64:
            hi |= w << np.uint64(s - 64) if s >= 64 \
                else w >> np.uint64(64 - s)
    return hi, lo


def _empty_counts():
    z = np.zeros(0, np.uint64)
    return z, z, np.zeros(0, np.int64)


def count_kmers_device(codes: np.ndarray, k: int, min_count: int = 1,
                       device: torch.device | str | None = None):
    """Canonical k-mer counts of ``codes`` (2-bit codes, :data:`SEP`
    between reads) on ``device`` (the card unless the caller says
    ``"cpu"``); the contract and output of :func:`count_kmers_host`:
    (hi, lo) uint64 sorted, int64 counts >= ``min_count``."""
    from haslr_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    _check_k(k)
    if len(codes) < k:
        return _empty_counts()
    c = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)
    # a k-mer is valid when its window holds no separator
    bad = torch.cumsum((c >= SEP).to(torch.int32), 0, dtype=torch.int32)
    bad = torch.cat([bad.new_zeros(1), bad])
    valid = (bad[k:] - bad[:-k]) == 0
    del bad  # each intermediate is freed once used: 2^28 codes take GBs
    words = _canonical_words(c, k, valid)
    del c, valid
    words, _ = _sort_rows(words)
    words, counts = _run_counts(words, min_count)
    return (*_words_to_pair([w.cpu().numpy() for w in words], k),
            counts.cpu().numpy())


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
