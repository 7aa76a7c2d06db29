"""Judge an assembly (``asm.final.fa``) against the generated genome.

- ``kmer_missed``: the share of the genome's distinct canonical 31-mers
  that the assembly lacks, each replicon's ends (``END_TRIM`` bases)
  left out: the generator's replicons are linear, and reads of 18-60 kb
  cover a linear end's last 10 kb fewer than ~10 deep, where an end
  contig with under ``--edge-sup`` joining reads is rightly dropped (E.
  coli's chromosome is circular and has no such ends).
- ``kmer_false``: the share of the assembly's distinct canonical 31-mers
  that the genome lacks: consensus errors and false joins make them.
- ``contigs``: how many sequences the assembly has.  The graph stack
  makes one a chain of joins it keeps, so a join it loses shows here;
  the k-mer numbers see a lost join only through the few 31-mers that
  span it.
- ``length_error``: how far the assembly's total length lies from the
  genome's, beyond the ``END_TRIM`` that each replicon end may lack, as
  a share of the genome: a gap left unfilled or filled twice shows
  here, where the k-mer numbers miss it (a repeat copy's 31-mers are
  all in its other copies).

``ng50`` is reported beside them (the NG50 of the replicons' lengths).
"""

from __future__ import annotations

import numpy as np

K = 31
END_TRIM = 10_000
_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def read_fasta(path: str) -> list:
    """Sequences of a FASTA file as 2-bit codes (4 for any other base)."""
    seqs, cur = [], []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                cur = []
            else:
                cur.append(line)
    if cur:
        seqs.append(b"".join(cur))
    return [_CODE[np.frombuffer(s.upper(), np.uint8)] for s in seqs]


def canonical_kmers(codes: np.ndarray, k: int = K) -> np.ndarray:
    """Distinct canonical k-mers of one sequence, 2 bits a base; k-mers
    holding a base other than ACGT are left out."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = codes.astype(np.uint64)
    bad = np.convolve((codes > 3).astype(np.int64), np.ones(k, np.int64),
                      "valid") > 0
    c = np.where(codes > 3, 0, c).astype(np.uint64)
    rc = (np.uint64(3) - c)[::-1]
    fw = np.zeros(n, np.uint64)
    bw = np.zeros(n, np.uint64)
    two = np.uint64(2)
    for i in range(k):
        fw = (fw << two) | c[i : i + n]
        bw = (bw << two) | rc[i : i + n]
    can = np.minimum(fw, bw[::-1])
    return np.unique(can[~bad])


def ng50(lengths, genome_len: int) -> int:
    acc = 0
    for L in sorted(lengths, reverse=True):
        acc += L
        if acc >= genome_len / 2:
            return int(L)
    return 0


def judge(fasta_path: str, genome) -> dict:
    """The assembly stage's numbers for one output FASTA."""
    seqs = read_fasta(fasta_path)
    G = genome.length
    gk = np.unique(np.concatenate([
        canonical_kmers(genome.codes[a + END_TRIM : b - END_TRIM])
        for a, b in zip(genome.rep_off[:-1], genome.rep_off[1:])]))
    ak = np.unique(np.concatenate(
        [canonical_kmers(s) for s in seqs] or [np.zeros(0, np.uint64)]))
    allg = np.unique(np.concatenate([
        canonical_kmers(genome.codes[a:b])
        for a, b in zip(genome.rep_off[:-1], genome.rep_off[1:])]))
    hit = np.isin(gk, ak, assume_unique=True).sum()
    false = len(ak) - np.isin(ak, allg, assume_unique=True).sum()
    total = sum(len(s) for s in seqs)
    ends = 2 * END_TRIM * (len(genome.rep_off) - 1)
    return {
        "kmer_missed": float(1 - hit / max(len(gk), 1)),
        "kmer_false": float(false / max(len(ak), 1)),
        "contigs": len(seqs),
        "length_error": max(0, abs(total - G) - ends) / G,
        "ng50": ng50([len(s) for s in seqs], G),
    }
