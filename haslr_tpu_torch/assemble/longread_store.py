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

from haslr_tpu_torch import trace
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


def _passing_rows(cols, contigs, uniq_freq, cfg):
    """The rows of the native scan's columns that pass filters 1-4, each
    test as :func:`_python_records` makes it; None where that loop would
    raise on a record it reaches (a zero ``n_block`` past filter 1, a
    target id past the contigs), so that it runs and raises as it does."""
    n_match, n_block, mapq, t_id = cols[:, 9], cols[:, 10], cols[:, 11], \
        cols[:, 5]
    ok = ~(n_block < cfg.min_aln_block)
    if (n_block[ok] == 0).any():
        return None
    ok[ok] = ~(n_match[ok] / n_block[ok] < cfg.min_aln_sim)
    ok &= ~(mapq < cfg.min_aln_mapq)
    mean_kmer = np.asarray(contigs.mean_kmer, dtype=np.float64)
    if (t_id[ok] >= len(mean_kmer)).any():
        return None
    ok[ok] = ~(mean_kmer[t_id[ok]] > uniq_freq * (3 + cfg.max_uniq_dev))
    return np.flatnonzero(ok)


def _native_records(path, contigs, uniq_freq, cfg):
    """The PAF's records through the native scan
    (:func:`haslr_tpu_torch.native.paf_read_native`), as
    :func:`_python_records` yields them, the query id in place of its
    name (ids are plain decimals there, so they compare as the names do);
    None where the scan does not take the file.  The alignments' ops/lens
    are views of one decoded blob."""
    from haslr_tpu_torch import native

    res = native.paf_read_native(
        path, lambda cols: _passing_rows(cols, contigs, uniq_freq, cfg)
    )
    if res is None:
        return None
    cols, rows, ops, lens, off = res
    fields = cols[:, :12].tolist()
    slot = np.full(len(cols), -1, np.int64)
    slot[rows] = np.arange(len(rows))
    out = []
    for i, s in enumerate(slot.tolist()):
        f = fields[i]
        if s < 0:
            out.append((f[0], None))
            continue
        o0, o1 = int(off[s]), int(off[s + 1])
        out.append((f[0], Alignment(
            q_id=f[0], q_start=f[2], q_end=f[3], t_id=f[5],
            t_start=f[7], t_end=f[8], n_match=f[9], n_block=f[10],
            is_rev=f[4], mapq=f[11], t_len=f[6],
            ops=ops[o0:o1], lens=lens[o0:o1],
        )))
    return out


def _python_records(path, contigs, uniq_freq, cfg):
    """The PAF's records, each as (query name, its alignment, or None
    where it fails filters 1-4), read and parsed in Python."""
    for rec in cio.read_paf(path):
        # filters 1-3, then 4: drop alignments to high-copy contigs
        if (rec.n_block < cfg.min_aln_block
                or rec.n_match / rec.n_block < cfg.min_aln_sim
                or rec.mapq < cfg.min_aln_mapq
                or contigs.mean_kmer[int(rec.t_name)]
                > uniq_freq * (3 + cfg.max_uniq_dev)):
            yield rec.q_name, None
            continue
        ops, lens = ccigar.parse(rec.cigar)
        yield rec.q_name, Alignment(
            q_id=int(rec.q_name),
            q_start=rec.q_start,
            q_end=rec.q_end,
            t_id=int(rec.t_name),
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

    The file is read and the CIGARs of the records past filters 1-4 are
    decoded in one native pass (``native/paf_read.cpp``); without the
    native library, or on a file it does not take, in Python, which gives
    the same alignments (or raises).

    Counts ``asm.paf.records`` (lines read), ``asm.paf.cigars`` (CIGARs
    parsed: lines past filters 1-4), ``asm.paf.kept`` (alignments kept)
    and ``asm.paf.native`` (records the native scan read, 0 on the Python
    path) once a call (:func:`haslr_tpu_torch.trace.count`).
    """
    n_total = n_records = n_cigars = 0
    group: list[Alignment] = []
    last_q = None
    records = _native_records(path, contigs, uniq_freq, cfg)
    n_native = 0 if records is None else len(records)
    if records is None:
        records = _python_records(path, contigs, uniq_freq, cfg)

    def flush():
        nonlocal n_total
        if not group:
            return
        # sort by (q_end, q_start) — compare_Align_Seg2, Longread.cpp:52-55
        group.sort(key=lambda a: (a.q_end, a.q_start))
        kept = _process_group(group, contigs, uniq_freq, cfg)
        for a in kept:
            if n_native:
                # own its CIGAR, not a view that keeps the blob alive
                a.ops, a.lens = a.ops.copy(), a.lens.copy()
            lrs.alignments[a.q_id].append(a)
        n_total += len(kept)

    for n_records, (q, a) in enumerate(records, 1):
        if last_q is not None and q != last_q and group:
            flush()
            group = []
        if a is None:
            continue
        n_cigars += 1
        last_q = q
        group.append(a)
    flush()
    trace.count("asm.paf.records", n_records)
    trace.count("asm.paf.cigars", n_cigars)
    trace.count("asm.paf.kept", n_total)
    trace.count("asm.paf.native", n_native)
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
