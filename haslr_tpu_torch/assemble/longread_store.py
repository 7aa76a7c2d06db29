"""Long-read store and PAF ingestion (the filtering front door).

Replaces reference ``Longread.cpp``:

- :class:`Alignment` mirrors ``Align_Seq_t`` (``Longread.hpp:16-30``) with
  the CIGAR held as op-level numpy arrays.
- :meth:`LongreadStore.load_fasta` mirrors ``load_longread_compressed``
  (``Longread.cpp:109-162``): reads are 2-bit packed; ids are file order
  (the pipeline renames reads to sequential numeric ids first).
- :func:`load_alignments` mirrors ``load_alignment`` +
  ``process_lr_alignment_group`` (``Longread.cpp:182-302``): the four PAF
  filters, per-read sorting by (q_end, q_start), palindrome truncation and
  the middle-alignment 80%-contig-coverage filter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from haslr_tpu_torch.config import AssembleConfig
from haslr_tpu_torch.core import cigar as ccigar
from haslr_tpu_torch.core import io as cio
from haslr_tpu_torch.core import seq as cseq


@dataclass
class Alignment:
    """One filtered long-read→contig alignment (``Align_Seq_t`` analog)."""

    q_id: int
    q_start: int
    q_end: int      # exclusive
    t_id: int
    t_start: int
    t_end: int      # exclusive
    n_match: int
    n_block: int
    is_rev: int     # 1 if '-' strand
    mapq: int
    t_len: int = 0  # contig length (only the 80% middle filter reads this)
    ops: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    lens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def cigar(self) -> str:
        return ccigar.to_string(self.ops, self.lens)


class LongreadStore:
    def __init__(self):
        self.seqs = cseq.SeqStore()
        # per-read alignment lists, filled by load_alignments
        self.alignments: list[list[Alignment]] = []

    def __len__(self):
        return len(self.seqs)

    def add(self, seq: str) -> int:
        rid = self.seqs.add_str(seq)
        self.alignments.append([])
        return rid

    def length(self, rid: int) -> int:
        return self.seqs.lengths[rid]

    def get_codes(self, rid: int) -> np.ndarray:
        return self.seqs.get(rid)

    def get_str(self, rid: int) -> str:
        return self.seqs.get_str(rid)

    @classmethod
    def load_fasta(cls, path: str) -> "LongreadStore":
        store = cls()
        from haslr_tpu_torch import native

        nat = native.read_fastx_encoded(path)
        if nat is not None:
            codes, offsets, _names, _comments = nat
            for i in range(len(offsets) - 1):
                store.seqs.add(codes[offsets[i] : offsets[i + 1]])
                store.alignments.append([])
        else:
            for rec in cio.read_fastx(path):
                store.add(rec.seq)
        return store


def _process_group(
    alns: list[Alignment],
    contigs,
    uniq_freq: float,
    cfg: AssembleConfig,
) -> list[Alignment]:
    """Per-read group processing (``process_lr_alignment_group``,
    ``Longread.cpp:182-232``).

    1. Palindrome truncation: scanning in (q_end, q_start) order, the group
       is cut at the first repeated *unique* contig (mean_kmer strictly
       below ``uniq_freq * (1 + max_uniq_dev)``), Longread.cpp:186-202.
    2. Middle alignments that cover < 80% of their contig are dropped
       (first/last alignments are exempt), Longread.cpp:207.

    Groups of size <= 1 are dropped entirely (reference returns early
    without appending, Longread.cpp:184).
    """
    if len(alns) <= 1:
        return []
    thresh = uniq_freq * (1 + cfg.max_uniq_dev)
    seen: set[int] = set()
    cut = len(alns)
    for i, a in enumerate(alns):
        if contigs.mean_kmer[a.t_id] < thresh:
            if a.t_id in seen:
                cut = i
                break
            seen.add(a.t_id)
    alns = alns[:cut]

    out = []
    for i, a in enumerate(alns):
        if (
            0 < i < len(alns) - 1
            and (a.t_end - a.t_start) / a.t_len < 0.8
        ):
            continue
        out.append(a)
    return out


def load_alignments(
    path: str,
    contigs,
    lrs: LongreadStore,
    uniq_freq: float,
    cfg: AssembleConfig,
) -> int:
    """Stream a PAF file into per-read alignment lists; returns the count.

    Line filters (``Longread.cpp:262-272``):
      1. ``n_block >= min_aln_block``
      2. ``n_match / n_block >= min_aln_sim``
      3. ``mapq >= min_aln_mapq``
      4. target contig mean_kmer <= ``uniq_freq * (3 + max_uniq_dev)``

    Query and target names must be integer ids (the pipeline renames reads
    and contigs to ordinals, reference ``Longread.cpp:286-289``).  Lines of
    one read must be consecutive (minimap2 output order), as the reference
    assumes.
    """
    n_total = 0
    group: list[Alignment] = []
    last_q: str | None = None

    def flush():
        nonlocal n_total
        if not group:
            return
        # sort by (q_end, q_start) — compare_Align_Seg2, Longread.cpp:52-55
        group.sort(key=lambda a: (a.q_end, a.q_start))
        kept = _process_group(group, contigs, uniq_freq, cfg)
        for a in kept:
            lrs.alignments[a.q_id].append(a)
        n_total += len(kept)

    for rec in cio.read_paf(path):
        if last_q is not None and rec.q_name != last_q and group:
            flush()
            group = []
        # filters 1-3
        if rec.n_block < cfg.min_aln_block:
            continue
        if rec.n_match / rec.n_block < cfg.min_aln_sim:
            continue
        if rec.mapq < cfg.min_aln_mapq:
            continue
        # filter 4: drop alignments to high-copy contigs
        t_id = int(rec.t_name)
        if contigs.mean_kmer[t_id] > uniq_freq * (3 + cfg.max_uniq_dev):
            continue
        ops, lens = ccigar.parse(rec.cigar)
        a = Alignment(
            q_id=int(rec.q_name),
            q_start=rec.q_start,
            q_end=rec.q_end,
            t_id=t_id,
            t_start=rec.t_start,
            t_end=rec.t_end,
            n_match=rec.n_match,
            n_block=rec.n_block,
            is_rev=1 if rec.strand == "-" else 0,
            mapq=rec.mapq,
            t_len=rec.t_len,
            ops=ops,
            lens=lens,
        )
        last_q = rec.q_name
        group.append(a)
    flush()
    return n_total


def fix_overlapping_alignments(alns: list[Alignment]) -> None:
    """Split overlapping consecutive alignment pairs at the overlap midpoint.

    Reference ``fix_overlapping_alignments`` (``Longread.cpp:430-512``):
    when alignment i's query interval overlaps alignment i+1's, both CIGARs
    are truncated so that i ends at ``q_end - ov/2 - 1`` and i+1 starts at
    ``q_start + (ov - ov/2)``, each walk rolling back to end on a match
    column; coordinates, n_block (column count) and n_match are updated.
    The four strand cases map onto :func:`haslr_tpu_torch.core.cigar.
    truncate_at_query` with reversed op arrays where the reference reverses
    the expanded string.
    """
    for i in range(len(alns) - 1):
        a, b = alns[i], alns[i + 1]
        if a.q_end <= b.q_start:
            continue
        ov = a.q_end - b.q_start
        # --- fix first alignment: truncate its tail ---
        q_pos = a.q_end - ov // 2 - 1
        if a.is_rev == 0:
            k_ops, k_lens, rq, rt = ccigar.truncate_at_query(
                a.ops, a.lens, a.q_start, a.t_start, +1, +1, q_pos
            )
            a.q_end = rq + 1
            a.t_end = rt + 1
            a.ops, a.lens = k_ops, k_lens
        else:
            r_ops, r_lens = ccigar.reverse(a.ops, a.lens)
            k_ops, k_lens, rq, rt = ccigar.truncate_at_query(
                r_ops, r_lens, a.q_start, a.t_end - 1, +1, -1, q_pos
            )
            a.q_end = rq + 1
            a.t_start = rt
            a.ops, a.lens = ccigar.reverse(k_ops, k_lens)
        a.n_block = ccigar.n_columns(a.ops, a.lens)
        a.n_match = ccigar.n_matches(a.ops, a.lens)
        # --- fix second alignment: truncate its head ---
        q_pos = b.q_start + (ov - ov // 2)
        if b.is_rev == 0:
            r_ops, r_lens = ccigar.reverse(b.ops, b.lens)
            k_ops, k_lens, rq, rt = ccigar.truncate_at_query(
                r_ops, r_lens, b.q_end - 1, b.t_end - 1, -1, -1, q_pos
            )
            b.q_start = rq
            b.t_start = rt
            b.ops, b.lens = ccigar.reverse(k_ops, k_lens)
        else:
            k_ops, k_lens, rq, rt = ccigar.truncate_at_query(
                b.ops, b.lens, b.q_end - 1, b.t_start, -1, +1, q_pos
            )
            b.q_start = rq
            b.t_end = rt + 1
            b.ops, b.lens = k_ops, k_lens
        b.n_block = ccigar.n_columns(b.ops, b.lens)
        b.n_match = ccigar.n_matches(b.ops, b.lens)


def dump_alignments(lrs: LongreadStore, path: str) -> None:
    """Debug dump of the loaded alignments as PAF-like rows
    (``print_loaded_alignments``, Longread.cpp:705-718) — diffable before
    and after overlap fixing."""
    with open(path, "w") as fp:
        for rid, alns in enumerate(lrs.alignments):
            for a in alns:
                strand = "-" if a.is_rev else "+"
                fp.write(
                    f"{a.q_id}\t{a.q_start}\t{a.q_end}\t{strand}\t{a.t_id}"
                    f"\t{a.t_start}\t{a.t_end}\t{a.n_match}\t{a.n_block}"
                    f"\t{a.mapq}\tcg:Z:{a.cigar}\n"
                )


def dump_reads(lrs: LongreadStore, path: str) -> None:
    """Debug dump of the decoded reads (``print_loaded_lrs``,
    Longread.cpp:695-703)."""
    with open(path, "w") as fp:
        for rid in range(len(lrs)):
            fp.write(f">{rid}\n{lrs.get_str(rid)}\n")


def fix_alignments(lrs: LongreadStore) -> None:
    """Apply overlap fixing to every read (``fix_alignments``,
    Longread.cpp:626-635)."""
    for alns in lrs.alignments:
        if len(alns) > 1:
            fix_overlapping_alignments(alns)
