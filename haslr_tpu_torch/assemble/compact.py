"""Compact long reads: each read becomes an ordered chain of unique-contig
anchors via weighted interval scheduling.

Replaces reference ``find_best_scheduling`` / ``build_compact_longreads``
(``Longread.cpp:514-624``) and ``print_compact_longreads``
(``Longread.cpp:675-693``).
"""

from __future__ import annotations

from haslr_tpu_torch.config import AssembleConfig
from haslr_tpu_torch.assemble.longread_store import Alignment, LongreadStore
from haslr_tpu_torch.core.intervals import weighted_interval_scheduling


def find_best_scheduling(
    alns: list[Alignment],
    contigs,
    uniq_freq: float,
    cfg: AssembleConfig,
    min_aln_block: int | None = None,
    copy_count: int = 1,
) -> list[Alignment]:
    """Select the max-matched-bases chain of non-overlapping alignments.

    Filters before the DP (``Longread.cpp:532-539``): alignment block must
    be >= ``min_aln_block`` and the target contig's mean k-mer frequency at
    most ``uniq_freq * (copy_count + max_uniq_dev)``; then the weighted
    interval scheduling DP of ``Longread.cpp:564-601`` (weights = n_match).
    """
    if min_aln_block is None:
        min_aln_block = cfg.min_aln_block
    thresh = uniq_freq * (copy_count + cfg.max_uniq_dev)
    uniq = [
        a
        for a in alns
        if a.n_block >= min_aln_block and contigs.mean_kmer[a.t_id] <= thresh
    ]
    if not uniq:
        return []
    chosen = weighted_interval_scheduling(
        [a.q_start for a in uniq],
        [a.q_end for a in uniq],
        [a.n_match for a in uniq],
    )
    return [uniq[i] for i in chosen]


def build_compact_longreads(
    lrs: LongreadStore,
    contigs,
    uniq_freq: float,
    cfg: AssembleConfig,
    copy_count: int = 1,
) -> list[list[Alignment]]:
    """Per-read anchor chains (``build_compact_longreads``,
    Longread.cpp:612-624)."""
    return [
        find_best_scheduling(alns, contigs, uniq_freq, cfg, copy_count=copy_count)
        if alns
        else []
        for alns in lrs.alignments
    ]


def write_compact_longreads(compact: list[list[Alignment]], path: str) -> None:
    """Write the ``compact_uniq.txt`` artifact, format-compatible with
    ``print_compact_longreads`` (Longread.cpp:675-693)."""
    with open(path, "w") as fp:
        for i, chain in enumerate(compact):
            fp.write(f">{i}\t")
            for a in chain:
                strand = "-" if a.is_rev else "+"
                fp.write(
                    f"{a.q_start}-{a.q_end}:{a.t_id}:{strand}:"
                    f"{a.t_start}-{a.t_end}\t"
                )
            fp.write("\n")
