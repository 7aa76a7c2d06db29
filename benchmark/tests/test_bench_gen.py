"""The generator: same seed, same bytes; distributions as configured;
true CIGARs that re-apply the reads' edits; E. coli reads in seconds."""

import filecmp
import json
import os
import re
import time

import numpy as np
import pytest

from benchmark import gen, run
from benchmark.tests.small import shrink
from benchmark.gen import longreads
from benchmark.gen.genome import revcomp


def small_cfg(share=0.02):
    return shrink(share)(run.load_json(run.BENCH, "configs",
                                       "ecoli_pacbio.json"))


def read_paf(path):
    """(read, q_start, q_end, minus, contig, t_start, t_end, n_match,
    n_block, cigar) a record."""
    out = []
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            out.append((int(c[0]), int(c[2]), int(c[3]), c[4] == "-",
                        int(c[5]), int(c[7]), int(c[8]), int(c[9]),
                        int(c[10]), c[-1][5:]))
    return out


def apply_cigar(q, t, cigar):
    """(whether the CIGAR consumes exactly q and t, matching bases,
    alignment columns)."""
    i = j = n_match = n_block = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            n_match += int((q[i : i + n] == t[j : j + n]).sum())
            i, j = i + n, j + n
        elif op == "I":
            i += n
        else:
            j += n
        n_block += n
    return i == len(q) and j == len(t), n_match, n_block


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = gen.make_dataset(small_cfg(), 2**31 + 17,
                         str(tmp_path_factory.mktemp("ds")))
    gen.write_true_paf(d, d.path("map.paf"))
    return d


def test_same_seed_same_bytes(tmp_path, ds):
    other = gen.make_dataset(small_cfg(), 2**31 + 17, str(tmp_path))
    gen.write_true_paf(other, other.path("map.paf"))
    for f in ("contigs.fa", "lr.fa", "map.paf"):
        assert filecmp.cmp(ds.path(f), other.path(f), shallow=False), f
    third = gen.make_dataset(small_cfg(), 2**31 + 18, str(tmp_path / "b"))
    assert not filecmp.cmp(ds.path("lr.fa"), third.path("lr.fa"),
                           shallow=False)


def test_read_lengths_as_configured():
    """The raw set's lengths have the configured mean and sd; --cov-lr
    keeps its longest, longest first, up to the read that crosses the
    budget."""
    lc = run.load_json(run.BENCH, "configs", "ecoli_pacbio.json")[
        "long_reads"]
    rep_off = np.array([0, 2_000_000, 3_000_000])
    G = int(rep_off[-1])
    args = (lc["raw_coverage"], lc["len_mean"], lc["len_sd"],
            lc["len_min"], lc["len_max"])
    _, raw, _ = longreads.draw_layout(np.random.default_rng(4), rep_off,
                                      *args, 10**6, G)
    assert lc["raw_coverage"] <= raw.sum() / G < lc["raw_coverage"] + 0.1
    assert raw.min() >= lc["len_min"] and raw.max() <= lc["len_max"]
    assert abs(raw.mean() / lc["len_mean"] - 1) < 0.03
    assert abs(raw.std() / lc["len_sd"] - 1) < 0.1
    starts, kept, strand = longreads.draw_layout(
        np.random.default_rng(4), rep_off, *args, lc["cov_lr"], G)
    budget = lc["cov_lr"] * G
    assert kept.sum() >= budget > kept[:-1].sum()
    assert np.array_equal(kept, raw[: len(kept)])
    # each read inside one replicon
    rep = np.searchsorted(rep_off, starts, side="right")
    assert (starts + kept <= rep_off[rep]).all()
    assert 0.4 < strand.mean() < 0.6


def test_reads_and_genome_as_configured(tmp_path):
    cfg = small_cfg(0.03)
    d = gen.make_dataset(cfg, 99, str(tmp_path))
    lc = cfg["long_reads"]
    tlen = np.diff(d.reads.tpl_off)
    assert (np.diff(tlen) <= 0).all()
    assert lc["cov_lr"] * lc["genome_size"] <= tlen.sum()
    e = lc["error_rate"]
    for kind, share in ((longreads.DEL, e / 3), (longreads.SUB, e / 3)):
        assert abs((d.reads.kind == kind).mean() - share) < 0.1 * share
    assert abs(d.reads.ins.mean() - e / 3) < 0.1 * e / 3
    # every planted copy and every contig placement reads the genome
    g = d.genome
    assert len(g.copy_fam) == sum(c for _n, c, _L in cfg["genome"]["families"])
    for c in range(len(g.copy_fam)):
        seq = g.fam_seqs[g.copy_fam[c]]
        got = g.codes[g.copy_start[c] : g.copy_start[c] + len(seq)]
        assert np.array_equal(got, revcomp(seq) if g.copy_rev[c] else seq)
    ct = d.contigs
    for p in range(len(ct.pl_contig)):
        s = d.genome.codes[ct.pl_start[p] : ct.pl_end[p]]
        want = ct.seqs[ct.pl_contig[p]]
        assert np.array_equal(revcomp(s) if ct.pl_rev[p] else s, want)
    # the read is its template mutated: equal where nothing happened
    r = 0
    read = d.reads.seq[d.reads.seq_off[r] : d.reads.seq_off[r + 1]]
    k = d.reads.kind[: tlen[r]]
    assert len(read) == (k != longreads.DEL).sum() + d.reads.ins[
        : tlen[r]].sum()


def test_true_cigars_reapply_the_edits(ds):
    recs = read_paf(ds.path("map.paf"))
    assert len(recs) > 100
    n_pl = np.bincount(ds.contigs.pl_contig)
    for (r, q0, q1, minus, contig, t0, t1, n_match, n_block,
         cigar) in recs:
        read = ds.reads.seq[ds.reads.seq_off[r] : ds.reads.seq_off[r + 1]]
        q = revcomp(read[q0:q1]) if minus else read[q0:q1]
        t = ds.contigs.seqs[contig][t0:t1]
        fits, got_match, got_block = apply_cigar(q, t, cigar)
        assert fits and got_block == n_block
        # unique contigs: the matches are exactly the untouched bases
        if n_pl[contig] == 1:
            assert got_match == n_match
    # every read-contig pair that shares 2 kb of the genome has a record
    pairs = {(r[0], r[4]) for r in recs}
    tlen = np.diff(ds.reads.tpl_off)
    ct = ds.contigs
    for r in range(0, len(ds.reads), 7):
        a, b = ds.reads.tpl_start[r], ds.reads.tpl_start[r] + tlen[r]
        share = np.minimum(b, ct.pl_end) - np.maximum(a, ct.pl_start)
        for p in np.nonzero((share >= 2000)
                            & np.isin(ct.pl_contig, ds.kept))[0]:
            assert (r, ct.pl_contig[p]) in pairs


def test_true_paf_holds_only_the_kept_contigs(tmp_path):
    cfg = small_cfg()
    cfg["min_src"] = 1300
    d = gen.make_dataset(cfg, 11, str(tmp_path))
    gen.write_true_paf(d, d.path("map.paf"))
    named = {r[4] for r in read_paf(d.path("map.paf"))}
    short = set(np.nonzero(d.contigs.lengths() < 1300)[0])
    assert short and named and not named & short
    assert named <= set(d.kept)


def test_ecoli_long_reads_in_seconds():
    cfg = run.load_json(run.BENCH, "configs", "ecoli_pacbio.json")
    rng = np.random.default_rng(3)
    G = cfg["genome"]["replicons"][0]
    codes = rng.integers(0, 4, G, dtype=np.uint8)
    t = time.time()
    reads = longreads.make_long_reads(rng, codes, np.array([0, G]),
                                      cfg["long_reads"])
    dt = time.time() - t
    assert reads.n_bases > 110e6
    assert dt < 15, f"{dt:.1f} s for {reads.n_bases / 1e6:.0f} Mbp"


def test_configs_name_themselves():
    for f in os.listdir(os.path.join(run.BENCH, "configs")):
        cfg = run.load_json(run.BENCH, "configs", f)
        assert cfg["name"] + ".json" == f
        json.dumps(cfg)
