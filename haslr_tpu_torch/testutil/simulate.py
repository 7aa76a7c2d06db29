"""Synthetic hybrid-assembly dataset generator.

The reference repo has no test suite (SURVEY.md §4); its de-facto
integration test is the E. coli quick start, which needs external data we
cannot download.  This module generates a ground-truth dataset exercising
the same pipeline: a random genome, short-read contigs (genome segments
with minia-style KC/km header tags, optionally reverse-complemented and
shuffled), noisy long reads with known error traces, and an exact PAF of
read→contig alignments derived from those traces (so the assembler front
door sees realistic minimap2-like input without needing an aligner).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from haslr_tpu_torch.core import cigar as ccigar
from haslr_tpu_torch.core import seq as cseq

BASES = "ACGT"


def random_genome(rng, length: int) -> str:
    return "".join(np.array(list(BASES))[rng.integers(0, 4, length)])


def genome_with_repeats(
    rng,
    length: int,
    n_families: int = 2,
    copies_per_family: int = 4,
    repeat_len: int = 400,
    divergence: float = 0.0,
    return_layout: bool = False,
    base: str | None = None,
):
    """Random genome with interspersed repeat copies.

    Repeats are what fragment a de Bruijn assembly into contigs — the
    structure HASLR's backbone graph exists to bridge.  By default copies
    are exact (worst case for the assembler's uniqueness filters) and
    placed at random positions, some reverse-complemented.

    ``divergence > 0`` substitutes that fraction of each COPY's bases
    independently (e.g. 0.02 => ~98% identity between copies) — the
    diverged-family regime real genomes show, which stresses the
    aligner's MAPQ competitor suppression rather than the k-mer
    uniqueness filters.

    ``return_layout=True`` additionally returns the planted copy
    positions as ``[(family, pos, repeat_len), ...]`` (later copies may
    overwrite earlier ones at overlapping positions).

    ``base``: plant into this sequence instead of a fresh random genome
    (layering exact + diverged families on one genome)."""
    g = list(base if base is not None else random_genome(rng, length))
    assert len(g) == length
    families = [random_genome(rng, repeat_len) for _ in range(n_families)]
    layout = []
    for fi, fam in enumerate(families):
        for _ in range(copies_per_family):
            pos = int(rng.integers(0, length - repeat_len))
            layout.append((fi, pos, repeat_len))
            copy = fam
            if divergence > 0:
                chars = list(copy)
                n_mut = rng.binomial(repeat_len, divergence)
                for i in rng.choice(repeat_len, n_mut, replace=False):
                    alt = BASES[rng.integers(0, 4)]
                    while alt == chars[i]:
                        alt = BASES[rng.integers(0, 4)]
                    chars[i] = alt
                copy = "".join(chars)
            s = copy if rng.random() < 0.5 else cseq.revcomp(copy)
            g[pos : pos + repeat_len] = list(s)
    if return_layout:
        return "".join(g), layout
    return "".join(g)


@dataclass
class SimContig:
    cid: int
    start: int       # genome start
    end: int         # genome end (exclusive)
    is_rev: int      # stored reverse-complemented?
    seq: str
    km: float
    kc: int


@dataclass
class SimRead:
    rid: int
    start: int       # genome start of the span
    end: int         # genome end (exclusive)
    strand: int      # 1 = read is revcomp of the genome-forward sequence
    seq: str         # the read as sequenced (strand applied)
    # per genome position in [start, end): 'M'/'D' plus insertions after
    ops: list = field(default_factory=list)  # list of (op, n_ins)
    is_sub: list = field(default_factory=list)


def mutate_with_trace(rng, template: str, error_rate: float,
                      homopolymer_bias: float = 0.0):
    """Apply sub/ins/del errors; return (seq, ops, is_sub).

    ``ops[i]`` = ('M'|'D', n_insertions_after) for template position i;
    ``is_sub[i]`` marks substituted positions (alignment column still M).

    ``homopolymer_bias``: per extra base of the homopolymer run a
    position sits in, the INDEL share of its error rate grows by this
    factor (capped at 5x) and inserted bases copy the run's base — the
    dominant PacBio CLR / ONT error mode (run-length miscalls), which
    the reference's ``-Hk17`` homopolymer-compressed preset exists for
    (``bin/haslr.py:90-95``).  0 keeps the legacy uniform iid model
    byte-for-byte (same RNG consumption)."""
    out = []
    ops = []
    is_sub = []
    third = error_rate / 3
    run = 0
    prev = ""
    for i, ch in enumerate(template):
        run = run + 1 if ch == prev else 1
        prev = ch
        if homopolymer_bias > 0.0:
            scale = min(1.0 + homopolymer_bias * (run - 1), 5.0)
            p_del = third * scale
            p_sub = third
            p_ins = third * scale
        else:
            p_del = p_sub = p_ins = third
        r = rng.random()
        n_ins = 0
        if r < p_del:
            ops.append(("D", 0))
            is_sub.append(False)
            continue
        if r < p_del + p_sub:
            alt = BASES[rng.integers(0, 4)]
            while alt == ch:
                alt = BASES[rng.integers(0, 4)]
            out.append(alt)
            is_sub.append(True)
        else:
            out.append(ch)
            is_sub.append(False)
        if p_del + p_sub <= r < p_del + p_sub + p_ins:
            n_ins = 1
            if homopolymer_bias > 0.0 and run > 1:
                out.append(ch)  # run-length overcall: duplicate the base
                rng.integers(0, 4)  # keep RNG stream aligned
            else:
                out.append(BASES[rng.integers(0, 4)])
        ops.append(("M", n_ins))
    return "".join(out), ops, is_sub


def make_contigs(
    rng,
    genome: str,
    mean_len: int = 2000,
    gap_len: int = 200,
    coverage_km: float = 30.0,
    kmer: int = 49,
    rev_fraction: float = 0.3,
    shuffle: bool = True,
) -> list[SimContig]:
    """Cut the genome into contigs separated by gaps (the gaps are what the
    long-read consensus must reconstruct)."""
    contigs = []
    pos = 0
    n = len(genome)
    while pos + 300 < n:
        clen = int(rng.integers(mean_len // 2, mean_len * 3 // 2))
        end = min(pos + clen, n)
        s = genome[pos:end]
        is_rev = int(rng.random() < rev_fraction)
        if is_rev:
            s = cseq.revcomp(s)
        km = float(coverage_km * rng.uniform(0.85, 1.15))
        kc = int(km * max(1, len(s) - kmer + 1))
        contigs.append(SimContig(0, pos, end, is_rev, s, km, kc))
        pos = end + int(rng.integers(gap_len // 2, gap_len * 3 // 2))
    if shuffle:
        rng.shuffle(contigs)
    for i, c in enumerate(contigs):
        c.cid = i
    return contigs


# above this many total read bases make_reads switches to the
# vectorized generator (different RNG stream, no error traces): the
# per-base python mutate loop runs ~1-3 us/base, which at a 50 Mb
# genome's 750 Mbp of long reads is tens of minutes of pure simulation
FAST_READS_THRESHOLD = 100_000_000


def _mutate_fast(rng, codes: np.ndarray, error_rate: float) -> np.ndarray:
    """Vectorized sub/ins/del mutation of a 2-bit code array (same
    marginal distributions as mutate_with_trace with bias 0; no trace)."""
    n = len(codes)
    r = rng.random(n)
    third = error_rate / 3
    keep = r >= third
    sub = (r >= third) & (r < 2 * third)
    ins = (r >= 2 * third) & (r < error_rate)
    out = codes.copy()
    # uniform over the three non-original bases
    out[sub] = (out[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
    # expansion: kept base (maybe) + optional inserted base after
    n_out = keep.astype(np.int64) + ins.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(n_out)])
    res = np.empty(offs[-1], np.uint8)
    res[offs[:-1][keep]] = out[keep]
    ins_pos = offs[:-1][ins] + keep[ins].astype(np.int64)
    res[ins_pos] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
    return res


def _make_reads_fast(rng, genome, coverage, mean_len, error_rate):
    from haslr_tpu_torch.core import seq as cseq

    n = len(genome)
    codes = cseq.encode(genome)
    n_reads = int(np.ceil(coverage * n / mean_len)) + 1
    lens = rng.integers(mean_len // 2, mean_len * 3 // 2, n_reads)
    lens = np.minimum(lens, n)
    starts = rng.integers(0, n - lens + 1)
    reads = []
    total = 0
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i in range(n_reads):
        if total >= coverage * n:
            break
        rlen = int(lens[i])
        start = int(starts[i])
        mutated = _mutate_fast(
            rng, codes[start : start + rlen], error_rate
        )
        strand = int(rng.random() < 0.5)
        if strand:
            mutated = 3 - mutated[::-1]
        seq = chars[mutated].tobytes().decode()
        reads.append(
            SimRead(len(reads), start, start + rlen, strand, seq, [], [])
        )
        total += len(seq)
    return reads


def make_reads(
    rng,
    genome: str,
    coverage: float = 20.0,
    mean_len: int = 8000,
    error_rate: float = 0.06,
    homopolymer_bias: float = 0.0,
) -> list[SimRead]:
    n = len(genome)
    if (
        coverage * n > FAST_READS_THRESHOLD
        and homopolymer_bias == 0.0
    ):
        # scale regime: vectorized path (no per-base error traces, so
        # true_paf_records cannot be used on these reads — large-scale
        # benches map with the real aligner anyway)
        return _make_reads_fast(rng, genome, coverage, mean_len,
                                error_rate)
    total = 0
    reads = []
    while total < coverage * n:
        rlen = int(rng.integers(mean_len // 2, mean_len * 3 // 2))
        rlen = min(rlen, n)
        start = int(rng.integers(0, n - rlen + 1))
        template = genome[start : start + rlen]
        seq, ops, is_sub = mutate_with_trace(
            rng, template, error_rate, homopolymer_bias
        )
        strand = int(rng.random() < 0.5)
        if strand:
            seq = cseq.revcomp(seq)
        reads.append(
            SimRead(len(reads), start, start + rlen, strand, seq, ops, is_sub)
        )
        total += len(seq)
    return reads


def make_short_reads(
    rng,
    genome: str,
    coverage: float = 40.0,
    read_len: int = 150,
    error_rate: float = 0.002,
) -> list[str]:
    """Illumina-like short reads (substitution errors only), both strands.

    Fully vectorized (windows gathered from the encoded genome, one
    mutation mask, batch revcomp) so multi-Mb genomes simulate in seconds.
    """
    n = len(genome)
    codes = cseq.encode(genome)
    n_reads = int(np.ceil(coverage * n / read_len))
    starts = rng.integers(0, max(1, n - read_len + 1), n_reads)
    wins = codes[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if error_rate > 0:
        mut = rng.random(wins.shape) < error_rate
        wins[mut] = rng.integers(0, 4, int(mut.sum()), dtype=np.int64)
    rc = rng.random(n_reads) < 0.5
    wins[rc] = 3 - wins[rc, ::-1]
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)[wins]
    return [row.tobytes().decode() for row in chars]


def write_short_reads(path: str, reads: list[str]):
    with open(path, "w") as fp:
        for i, s in enumerate(reads):
            fp.write(f"@sr{i}\n{s}\n+\n{'I' * len(s)}\n")


def true_paf_records(read: SimRead, contigs: list[SimContig], min_overlap=300):
    """Exact PAF lines for one read against every overlapping contig,
    derived from the error trace (minimap2 conventions: CIGAR in target
    order; '-' strand coordinates in the read's own frame)."""
    # prefix sums of query consumption per genome position of the read span
    span = read.end - read.start
    qoff = np.zeros(span + 1, dtype=np.int64)
    acc = 0
    for i, (op, n_ins) in enumerate(read.ops):
        acc += (1 if op == "M" else 0) + n_ins
        qoff[i + 1] = acc
    read_len = len(read.seq)
    out = []
    for c in contigs:
        a = max(read.start, c.start)
        b = min(read.end, c.end)
        if b - a < min_overlap:
            continue
        i0, i1 = a - read.start, b - read.start
        # trim edges so the alignment starts/ends on M
        while i0 < i1 and read.ops[i0][0] != "M":
            i0 += 1
        while i1 > i0 and read.ops[i1 - 1][0] != "M":
            i1 -= 1
        if i1 - i0 < 2:
            continue
        # build cigar over genome positions [i0, i1) in genome-forward order
        col_ops = []
        n_match = 0
        for i in range(i0, i1):
            op, n_ins = read.ops[i]
            if op == "M":
                col_ops.append(ccigar.M)
                if not read.is_sub[i]:
                    n_match += 1
            else:
                col_ops.append(ccigar.D)
            # trailing insertions belong between genome cols (skip at the end)
            if n_ins and i < i1 - 1:
                col_ops.extend([ccigar.I] * n_ins)
        ops_arr = np.array(col_ops, dtype=np.uint8)
        lens_arr = np.ones(len(col_ops), dtype=np.int64)
        ops_arr, lens_arr = ccigar.normalize(ops_arr, lens_arr)
        n_block = int(lens_arr.sum())
        # forward-frame query coords
        fq_start = int(qoff[i0])
        fq_end = fq_start + ccigar.query_len(ops_arr, lens_arr)
        # genome-forward target coords relative to the contig
        g_start, g_end = read.start + i0, read.start + i1
        if c.is_rev:
            t_start = c.end - g_end
            t_end = c.end - g_start
        else:
            t_start = g_start - c.start
            t_end = g_end - c.start
        # strand: '+' if read orientation matches contig orientation
        rev = read.strand ^ c.is_rev
        if read.strand == 0:
            q_start, q_end = fq_start, fq_end
        else:
            q_start, q_end = read_len - fq_end, read_len - fq_start
        if c.is_rev:
            # target order is the contig's frame: reverse the cigar columns
            ops_arr, lens_arr = ccigar.reverse(ops_arr, lens_arr)
        out.append(
            dict(
                q_name=str(read.rid),
                q_len=read_len,
                q_start=q_start,
                q_end=q_end,
                strand="-" if rev else "+",
                t_name=str(c.cid),
                t_len=len(c.seq),
                t_start=int(t_start),
                t_end=int(t_end),
                n_match=n_match,
                n_block=n_block,
                mapq=60,
                cigar=ccigar.to_string(ops_arr, lens_arr),
            )
        )
    out.sort(key=lambda r: r["q_start"])
    return out


def write_dataset(out_dir, genome, contigs, reads, min_overlap=300):
    """Write contigs.fa (minia-style headers), lr.fasta, map.paf; returns
    their paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    contig_path = f"{out_dir}/contigs.fa"
    with open(contig_path, "w") as fp:
        for c in contigs:
            fp.write(
                f">{c.cid} LN:i:{len(c.seq)} KC:i:{c.kc} km:f:{c.km:.3f}\n"
                f"{c.seq}\n"
            )
    lr_path = f"{out_dir}/lr.fasta"
    with open(lr_path, "w") as fp:
        for r in reads:
            fp.write(f">{r.rid}\n{r.seq}\n")
    paf_path = f"{out_dir}/map.paf"
    with open(paf_path, "w") as fp:
        for r in reads:
            for rec in true_paf_records(r, contigs, min_overlap):
                fp.write(
                    "{q_name}\t{q_len}\t{q_start}\t{q_end}\t{strand}\t"
                    "{t_name}\t{t_len}\t{t_start}\t{t_end}\t{n_match}\t"
                    "{n_block}\t{mapq}\ttp:A:P\tcg:Z:{cigar}\n".format(**rec)
                )
    return contig_path, lr_path, paf_path


def simulate(
    out_dir: str,
    genome_len: int = 50_000,
    seed: int = 0,
    coverage: float = 20.0,
    error_rate: float = 0.06,
    contig_mean_len: int = 2000,
    contig_gap: int = 200,
    rev_fraction: float = 0.3,
    read_mean_len: int = 8000,
):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    contigs = make_contigs(
        rng,
        genome,
        mean_len=contig_mean_len,
        gap_len=contig_gap,
        rev_fraction=rev_fraction,
    )
    reads = make_reads(
        rng, genome, coverage=coverage, mean_len=read_mean_len,
        error_rate=error_rate,
    )
    paths = write_dataset(out_dir, genome, contigs, reads)
    return genome, contigs, reads, paths
