"""The reference's judge on a genome of several replicons: each
replicon's ends are left out of ``kmer_missed`` and allowed for in
``length_error``; a replicon lost or two joined shows."""

import numpy as np
import pytest

from benchmark.gen import rng_streams
from benchmark.gen.genome import make_genome
from benchmark.reference import assembly

T = assembly.END_TRIM
BASES = np.frombuffer(b"ACGT", np.uint8)


def genome():
    return make_genome(rng_streams(2**31 + 11, 1)[0],
                       [90_000, 60_000, 75_000], [(1, 3, 500)], 500)


def judge(tmp_path, seqs, g):
    path = tmp_path / "asm.final.fa"
    path.write_bytes(b"".join(b">%d\n%s\n" % (i, BASES[s].tobytes())
                              for i, s in enumerate(seqs)))
    return assembly.judge(str(path), g)


def replicons(g):
    return [g.codes[a:b] for a, b in zip(g.rep_off[:-1], g.rep_off[1:])]


def test_every_replicon_whole(tmp_path):
    g = genome()
    r = judge(tmp_path, replicons(g), g)
    assert (r["kmer_missed"], r["kmer_false"], r["contigs"],
            r["length_error"]) == (0.0, 0.0, 3, 0.0)


def test_each_end_may_lack_its_trim(tmp_path):
    g = genome()
    r = judge(tmp_path, [s[T - 1 : len(s) - T + 1] for s in replicons(g)], g)
    assert (r["kmer_missed"], r["kmer_false"], r["length_error"]) == (
        0.0, 0.0, 0.0)


def test_a_lost_replicon_and_a_false_join_show(tmp_path):
    g = genome()
    a, b, c = replicons(g)
    lost = judge(tmp_path, [a, b], g)
    assert lost["kmer_missed"] > 0.2
    assert lost["length_error"] == pytest.approx(
        (len(c) - 6 * T) / g.length)
    joined = judge(tmp_path, [np.concatenate([a, b]), c], g)
    assert joined["kmer_missed"] == 0.0 and joined["contigs"] == 2
    assert joined["kmer_false"] > 0
