"""Configuration for the assembler and the pipeline driver.

Two frozen dataclasses mirror the reference's two config surfaces:

- :class:`AssembleConfig` mirrors the C++ ``global_options_t gopt``
  (reference ``src/haslr_assemble/src/Common.hpp:44-65``) with the defaults of
  ``Commandline.cpp:46-66``.
- :class:`PipelineConfig` mirrors the Python driver flags
  (reference ``bin/haslr.py:293-376``).

Unlike the reference (mutable global struct), configs here are immutable and
passed explicitly; derived values (``uniq_freq``) are returned by the stages
that compute them rather than mutated in place.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class AssembleConfig:
    """Options of the core assembler (``haslr_assemble`` equivalent).

    Defaults follow reference ``Commandline.cpp:56-64``.
    """

    # Minimum alignment block length (PAF col 11) to keep an alignment.
    min_aln_block: int = 500
    # Minimum alignment identity (col 10 / col 11).
    min_aln_sim: float = 0.85
    # Minimum MAPQ (col 12).
    min_aln_mapq: int = 55
    # Max deviation from the unique-contig mean k-mer frequency.
    max_uniq_dev: float = 0.15
    # Minimum number of supporting long reads per backbone edge.
    min_edge_sup: int = 3
    # Worker parallelism for coordinate/consensus stages (host-side batching).
    num_threads: int = 1

    # Consensus engine: "poa" = exact partial-order-alignment (SPOA-semantics,
    # host); "tpu" = batched align-to-draft + weighted pileup vote on TPU
    # (Pallas kernels). Scores follow reference Assemble.cpp:8-11.
    consensus_engine: str = "tpu"
    poa_match: int = 5
    poa_mismatch: int = -4
    poa_gap: int = -8

    # Graph cleaning parameters (hard-coded in reference main.cpp).
    tip_depths: tuple = (1, 2, 3)          # main.cpp:150-152
    simple_bubble_depth: int = 4           # main.cpp:175
    super_bubble_max_dist: int = 50000     # main.cpp:185

    # Repeat resolution (opt-in): join simple paths through read-supported
    # branching routes before stitching — the wired-up capability of the
    # reference's excluded Align_LR2path/Graph_repeat experiment
    # (Makefile:30-31, main.cpp:11-12).
    resolve_repeats: bool = False
    min_bridge_support: int = 2

    def replace(self, **kw) -> "AssembleConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PipelineConfig:
    """Options of the end-to-end pipeline driver (``haslr.py`` equivalent).

    Defaults follow reference ``bin/haslr.py:307-315``.
    """

    out: str = ""
    genome: str = ""            # estimated genome size, accepts k/m/g suffix
    long: tuple = ()            # long read files
    type: str = "pacbio"        # pacbio | nanopore | corrected
    short: tuple = ()           # short read files
    contig: str | None = None   # pre-assembled short-read contigs

    threads: int = 1
    cov_lr: int = 25            # long-read coverage to subsample (0 = all)
    aln_block: int = 500
    aln_sim: float = 0.85
    edge_sup: int = 3
    minia_kmer: int = 49
    minia_solid: int = 3
    minia_asm: str = "contigs"  # contigs | unitigs
    min_src: int = 250
    short_fofn: bool = False
    long_fofn: bool = False
    # device-mesh width for the TPU stages (k-mer merge, aligner
    # extension, consensus); 1 = single device, 0 = all visible devices
    devices: int = 1

    def assemble_config(self) -> AssembleConfig:
        return AssembleConfig(
            min_aln_block=self.aln_block,
            min_aln_sim=self.aln_sim,
            min_edge_sup=self.edge_sup,
            num_threads=self.threads,
        )


def parse_genome_size(s: str) -> int:
    """Parse a genome size with optional k/m/g suffix (e.g. ``4.6m``)."""
    s = s.strip().lower()
    mult = 1
    if s and s[-1] in "kmg":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1]]
        s = s[:-1]
    return int(float(s) * mult)
