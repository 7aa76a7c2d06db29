"""The benchmark's own data generator: a genome, its long reads with
their edit operations, the short-read contigs a de Bruijn assembler
would leave, and the true PAF, all from one seed and vectorised.

It is the benchmark's frozen copy of the patterns of the port's test
helper ``haslr_tpu_torch/testutil/simulate.py`` (repeat families,
minia-style contig headers, exact PAFs from error traces), rewritten so
that an E. coli read set generates in seconds.  Neither the program nor
its helpers are called: the generator is also the reference's truth.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from benchmark.gen import contigs as gcontigs
from benchmark.gen import genome as ggenome
from benchmark.gen import longreads as glong
from benchmark.gen import truepaf

BASES = np.frombuffer(b"ACGT", np.uint8)


def rng_streams(seed: int, n: int) -> list:
    """``n`` independent generators from one seed (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in ss.spawn(n)]


@dataclass
class Dataset:
    cfg: dict
    genome: ggenome.Genome
    reads: glong.LongReads
    contigs: gcontigs.Contigs
    kept: np.ndarray            # file ids of the contigs at --min-src
    dir: str

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)


def make_dataset(cfg: dict, seed: int, out_dir: str) -> Dataset:
    """The configuration's genome, long reads and contigs for ``seed``,
    with the contigs (``contigs.fa``, every one, as the assembler reads
    them) and the long reads (``lr.fa``) written into ``out_dir``.
    ``kept``: the contigs of at least ``min_src`` bases, which the
    mapping stage aligns the reads to."""
    g_rng, r_rng, c_rng = rng_streams(seed, 3)
    gc = cfg["genome"]
    genome = ggenome.make_genome(
        g_rng, gc["replicons"], [tuple(f) for f in gc["families"]],
        gc["min_gap"])
    reads = glong.make_long_reads(r_rng, genome.codes, genome.rep_off,
                                  cfg["long_reads"])
    sr = cfg["short_reads"]
    k = cfg["minia_kmer"]
    contigs = gcontigs.dbg_contigs(
        c_rng, genome, k, gcontigs.kmer_coverage(sr["coverage"],
                                                 sr["read_len"], k))
    kept = gcontigs.length_filtered(contigs, cfg["min_src"])
    os.makedirs(out_dir, exist_ok=True)
    ds = Dataset(cfg, genome, reads, contigs, kept, out_dir)
    write_contigs(ds.path("contigs.fa"), contigs, np.arange(len(contigs)), k)
    write_reads(ds.path("lr.fa"), reads, np.arange(len(reads)))
    return ds


def write_contigs(path: str, contigs: gcontigs.Contigs, ids, k: int):
    """minia's FASTA: ``>id LN:i: KC:i: km:f:`` and one sequence line."""
    with open(path, "wb") as fp:
        for i in ids:
            s = contigs.seqs[i]
            fp.write(f">{i} LN:i:{len(s)} KC:i:{contigs.kc[i]} "
                     f"km:f:{contigs.km[i]:.3f}\n".encode())
            fp.write(BASES[s].tobytes())
            fp.write(b"\n")


def write_reads(path: str, reads: glong.LongReads, ids):
    """The reads ``ids`` as FASTA named by their index, as the pipeline
    renames them."""
    chars = BASES[reads.seq]
    with open(path, "wb") as fp:
        for i in ids:
            fp.write(f">{i}\n".encode())
            fp.write(chars[reads.seq_off[i] : reads.seq_off[i + 1]].tobytes())
            fp.write(b"\n")


def write_true_paf(ds: Dataset, path: str, min_overlap: int = 300,
                   n_reads: int | None = None) -> truepaf.Records:
    """The true PAF of the first ``n_reads`` reads (all by default)
    against the contigs the mapping stage keeps (``ds.kept``)."""
    reads = ds.reads if n_reads is None else subset_reads(ds.reads, n_reads)
    places = np.nonzero(np.isin(ds.contigs.pl_contig, ds.kept))[0]
    return truepaf.write_paf(path, reads, ds.contigs, min_overlap, places)


def subset_reads(reads: glong.LongReads, n: int) -> glong.LongReads:
    """The first ``n`` reads (their names, indices, stay the same)."""
    return glong.LongReads(
        reads.seq[: reads.seq_off[n]], reads.seq_off[: n + 1],
        reads.tpl_start[:n], reads.tpl_off[: n + 1], reads.strand[:n],
        reads.kind[: reads.tpl_off[n]], reads.ins[: reads.tpl_off[n]])
