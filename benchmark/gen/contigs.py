"""Short-read contigs cut where a de Bruijn graph of order k breaks.

With exact repeats and error-free k-mer solidity, the graph branches at
both ends of every repeat copy, so its contigs are the unique stretches
between copies (and the replicons' ends) and one collapsed contig a
repeat family.  They are given as the pipeline's overlap-free contigs
(minia's k - 1 overlaps removed), each in a random orientation and in a
random file order, named by that order, with minia's header tags: the
mean k-mer coverage ``km`` (a family's carries its copy number) and the
k-mer count ``KC``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.gen.genome import Genome, revcomp


@dataclass
class Contigs:
    seqs: list              # uint8 codes a contig, in file order
    km: np.ndarray          # float (n,)
    kc: np.ndarray          # int64 (n,)
    # genome placements, several a family contig: contig id, global
    # start and end, and whether the contig reads the genome's revcomp
    pl_contig: np.ndarray
    pl_start: np.ndarray
    pl_end: np.ndarray
    pl_rev: np.ndarray

    def __len__(self) -> int:
        return len(self.seqs)

    def lengths(self) -> np.ndarray:
        return np.array([len(s) for s in self.seqs], np.int64)


def kmer_coverage(sr_coverage: float, sr_read_len: int, k: int) -> float:
    """Mean k-mer coverage of short reads of ``sr_coverage`` depth."""
    return sr_coverage * (sr_read_len - k + 1) / sr_read_len


def dbg_contigs(rng, genome: Genome, k: int, km_unique: float) -> Contigs:
    """Unique stretches of at least k bases and one contig a family."""
    lo = np.sort(np.concatenate([genome.rep_off[:-1],
                                 genome.copy_start + genome.copy_len]))
    hi = np.sort(np.concatenate([genome.rep_off[1:], genome.copy_start]))
    keep = hi - lo >= k
    lo, hi = lo[keep], hi[keep]
    n_u, n_f = len(lo), len(genome.fam_seqs)
    n = n_u + n_f
    flip = rng.random(n) < 0.5
    jitter = rng.uniform(0.95, 1.05, n)
    copies = np.bincount(genome.copy_fam, minlength=n_f)
    km = km_unique * jitter * np.concatenate([np.ones(n_u), copies])
    order = rng.permutation(n)          # order[i]: the source of file id i
    name_of = np.empty(n, np.int64)
    name_of[order] = np.arange(n)
    seqs = []
    for src in order:
        s = (genome.codes[lo[src] : hi[src]] if src < n_u
             else genome.fam_seqs[src - n_u])
        seqs.append(revcomp(s) if flip[src] else s.copy())
    lengths = np.array([len(s) for s in seqs], np.int64)
    km = km[order]
    kc = np.rint(km * np.maximum(1, lengths - k + 1)).astype(np.int64)
    fam_src = n_u + genome.copy_fam
    pl_contig = name_of[np.concatenate([np.arange(n_u), fam_src])]
    pl_start = np.concatenate([lo, genome.copy_start])
    pl_end = np.concatenate([hi, genome.copy_start + genome.copy_len])
    pl_rev = np.concatenate([flip[:n_u], flip[fam_src] ^ genome.copy_rev])
    o = np.argsort(pl_start)
    return Contigs(seqs, km, kc, pl_contig[o], pl_start[o], pl_end[o],
                   pl_rev[o])


def length_filtered(contigs: Contigs, min_len: int) -> np.ndarray:
    """File ids of the contigs the pipeline keeps at ``--min-src``."""
    return np.nonzero(contigs.lengths() >= min_len)[0]
