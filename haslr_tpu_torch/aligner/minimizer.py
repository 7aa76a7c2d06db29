"""Minimizer extraction (vectorized numpy; device path planned in
``haslr_tpu_torch.kernels.minimizer``).

Implements the (w, k)-minimizer scheme of Roberts et al. / minimap2: hash
every k-mer canonically (min of forward/revcomp hashes), slide a window of
w consecutive k-mers, keep each window's minimum — positions where the
minimum changes are the minimizers.  Strand is recorded from whichever
orientation achieved the canonical hash.  Optional homopolymer compression
(the reference's pacbio preset ``-H``) collapses base runs before hashing
and maps positions back to the original coordinates.
"""

from __future__ import annotations

import numpy as np

MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit finalizer (splitmix64-style) on uint64 arrays."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & MASK64
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & MASK64
    x = x ^ (x >> np.uint64(31))
    return x


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit packed k-mer integers for every position (len - k + 1)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    c = codes.astype(np.uint64)
    # rolling pack via cumulative shifts: kmer[i] = sum c[i+j] << 2(k-1-j)
    out = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        out = (out << np.uint64(2)) | c[j : n - k + 1 + j]
    return out


def revcomp_kmer_codes(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers."""
    x = (~kmers) & MASK64  # complement: 3 - c == ~c (2-bit)
    out = np.zeros_like(kmers)
    for _ in range(k):
        out = (out << np.uint64(2)) | (x & np.uint64(3))
        x >>= np.uint64(2)
    return out


def hpc_compress(codes: np.ndarray):
    """Homopolymer-compress; returns (compressed_codes, orig_positions)."""
    if len(codes) == 0:
        return codes, np.zeros(0, dtype=np.int64)
    keep = np.concatenate([[True], codes[1:] != codes[:-1]])
    return codes[keep], np.nonzero(keep)[0]


def minimizers(
    codes: np.ndarray, k: int, w: int, hpc: bool = False
):
    """Extract (w,k)-minimizers.

    Returns (hashes uint64, positions int64, ends int64, strands uint8):
    ``positions``/``ends`` are the start and one-past-end coordinates of
    the k-mer in the *original* sequence — under homopolymer compression a
    k-mer spans more than k original bases, and reverse-strand coordinate
    transforms need the true end; ``strand`` is 1 when the reverse-
    complement orientation won the canonical hash.
    """
    orig_len = len(codes)
    pos_map = None
    if hpc:
        codes, pos_map = hpc_compress(codes)
    n = len(codes)
    if n < k:
        z = np.zeros(0, dtype=np.uint64)
        zi = np.zeros(0, dtype=np.int64)
        return z, zi, zi.copy(), np.zeros(0, dtype=np.uint8)
    fwd = kmer_codes(codes, k)
    rev = revcomp_kmer_codes(fwd, k)
    strand = (rev < fwd).astype(np.uint8)
    canon = np.where(strand, rev, fwd)
    # skip palindromic k-mers (strand ambiguous), like minimap2
    ok = fwd != rev
    h = _mix64(canon)
    h = np.where(ok, h, MASK64)  # palindromes never win a window
    m = len(h)
    if m <= w:
        idx = np.array([int(np.argmin(h))])
    else:
        win = np.lib.stride_tricks.sliding_window_view(h, w)
        idx = win.argmin(axis=1) + np.arange(m - w + 1)
        idx = np.unique(idx)
    sel = idx[h[idx] != MASK64]
    positions = sel.astype(np.int64)
    ends = positions + k
    if pos_map is not None:
        full_map = np.concatenate([pos_map, [orig_len]])
        ends = full_map[positions + k]
        positions = pos_map[positions]
    return h[sel], positions, ends, strand[sel]
