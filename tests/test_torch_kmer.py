"""The port's k-mer counters on the CPU against the JAX package's: the
single-shot device counter (``kernels/kmer.py``), the streaming counter
(``kernels/kmer_stream.py``: spill, the device accumulator's
self-compaction and spill, the sharded phase-2 merge) and the
short-read stage and ``assemble_unitigs`` that call them, array for
array and byte for byte (ports of ``tests/test_sr.py:21-140``)."""

from collections import Counter

import numpy as np
import pytest
import torch

from haslr_tpu.core import seq as cseq
from haslr_tpu.kernels import kmer as jk
from haslr_tpu.kernels import kmer_stream as jks
from haslr_tpu.testutil import simulate

from haslr_tpu_torch.dist.mesh import make_mesh
from haslr_tpu_torch.kernels import kmer as pk
from haslr_tpu_torch.kernels import kmer_stream as pks


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_counts_equal(want, got):
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _with_seps(reads):
    return np.concatenate(
        [np.concatenate([r, [jk.SEP]]) for r in reads]).astype(np.uint8)


def _random_reads(seed, n, lo=60, hi=300, poly_t=80):
    """Random reads and a poly-T read: the canonical form of T^k is
    A^k, and in the reference a canonical k-mer's first word can be all
    ones (the pad sentinel), which only its ``n_valid`` survives."""
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, rng.integers(lo, hi)).astype(np.uint8)
             for _ in range(n)]
    reads.append(np.full(poly_t, 3, np.uint8))
    return reads


@pytest.mark.parametrize("k", [15, 31, 49])
def test_count_kmers_device_matches_reference(k):
    rng = np.random.default_rng(0)
    s = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    codes = np.concatenate(
        [cseq.encode(s), [4], cseq.encode(s[100:300]), [4],
         np.full(90, 3), [4], np.full(70, 0)]
    ).astype(np.uint8)
    want = jk.count_kmers_host(codes, k)
    _assert_counts_equal(want, jk.count_kmers_device(codes, k))
    _assert_counts_equal(want, pk.count_kmers_host(codes, k))
    _assert_counts_equal(want, pk.count_kmers_device(codes, k,
                                                     device="cpu"))
    brute = Counter()
    for part in (s, s[100:300], "T" * 90, "A" * 70):
        for i in range(len(part) - k + 1):
            km = part[i : i + k]
            brute[min(km, cseq.revcomp(km))] += 1
    assert len(want[2]) == len(brute)


@pytest.mark.parametrize("k,min_count", [
    (1, 1), (5, 2), (15, 3), (31, 2), (32, 1), (33, 2), (49, 3), (63, 2),
    (64, 1),
])
def test_count_kmers_device_every_word_split(k, min_count):
    """Every split of the k-mer over 31-base words and of the host pair
    over its 32-base lo word, with repeated reads so that the abundance
    filter keeps some and drops others."""
    reads = _random_reads(k, 50, lo=1)
    reads += reads[:15] + [np.full(80, 0, np.uint8)]
    codes = _with_seps(reads)
    want = jk.count_kmers_host(codes, k, min_count)
    _assert_counts_equal(want, pk.count_kmers_device(codes, k, min_count,
                                                     device="cpu"))


def test_count_kmers_device_empty_inputs():
    for codes, k in ((np.zeros(0, np.uint8), 5),
                     (np.array([0, 1, 2], np.uint8), 5),
                     (np.full(40, 4, np.uint8), 5),
                     (np.array([0, 1, 4, 2, 3, 4, 1], np.uint8), 3)):
        _assert_counts_equal(jk.count_kmers_host(codes, k),
                             pk.count_kmers_device(codes, k, device="cpu"))
    with pytest.raises(ValueError, match="1..64"):
        pk.count_kmers_device(np.zeros(100, np.uint8), 65, device="cpu")


def test_words_to_pair_matches_host_packing():
    """``_words_to_pair`` gives the host's (hi, lo) for each k-mer's
    31-base words, at every k the pair holds."""
    rng = np.random.default_rng(4)
    for k in (1, 30, 31, 32, 33, 62, 63, 64):
        codes = rng.integers(0, 4, 300).astype(np.uint8)
        hi, lo, valid = jk._pack_pair_np(codes, k)
        assert valid.all()
        c = codes.astype(np.int64)
        m = len(codes) - k + 1
        words = []
        for b0, b1 in pk._word_spans(k):
            w = np.zeros(m, np.int64)
            for j in range(b0, b1):
                w = (w << 2) | c[j : j + m]
            words.append(w)
        got_hi, got_lo = pk._words_to_pair(words, k)
        np.testing.assert_array_equal(got_hi, hi)
        np.testing.assert_array_equal(got_lo, lo)


STREAM_CASES = [(49, 1, 2), (49, 3, 4), (31, 2, 3), (15, 1, 2), (5, 2, 1)]


@pytest.mark.parametrize("k,min_count,prefix_bits", STREAM_CASES)
def test_streaming_matches_reference(k, min_count, prefix_bits, tmp_path):
    """Chunked input, device accumulator, and the prefix-partitioned host
    store with disk spill, each equal to the JAX streaming counter and
    to the host counter, the poly-T read included."""
    reads = _random_reads(3, 120)
    want = jk.count_kmers_host(_with_seps(reads), k, min_count)
    _assert_counts_equal(want, jks.count_kmers_streaming(
        reads, k, min_count, chunk_bases=8192, prefix_bits=prefix_bits))
    for spill in (None, str(tmp_path / "spill")):
        pks.PROF.clear()
        got = pks.count_kmers_streaming(
            reads, k, min_count, chunk_bases=8192, prefix_bits=prefix_bits,
            spill_dir=spill, device="cpu")
        _assert_counts_equal(want, got)
        assert ("phase1_acc" in pks.PROF) == (spill is None)
    assert not list((tmp_path / "spill").iterdir())  # taken and removed


def _duplicated_reads():
    """The reference test's reads: 300 copies of six 200-bp reads, then
    100 random ones, so that self-compaction shrinks the rows."""
    rng = np.random.default_rng(9)
    pool = [rng.integers(0, 4, 200).astype(np.uint8) for _ in range(6)]
    reads = [pool[int(rng.integers(0, 6))] for _ in range(300)]
    reads += [rng.integers(0, 4, rng.integers(60, 200)).astype(np.uint8)
              for _ in range(100)]
    return reads


@pytest.mark.parametrize("budget,compacts,spills", [
    (1 << 16, False, False),  # every chunk fits
    (1 << 13, True, True),    # the reference's: compaction, then a spill
    (1 << 14, True, False),   # compaction only: the distinct rows fit
    (1 << 9, False, True),    # below one chunk's rows: spills at once
])
def test_streaming_device_accumulator_budgets(budget, compacts, spills):
    """The device accumulator's self-compaction and its spill to the host
    store (``device_rows_budget`` rows at most on the device) keep the
    output equal to the JAX counter's at the same budget."""
    reads = _duplicated_reads()
    want = jk.count_kmers_host(_with_seps(reads), 31, 2)
    if budget in (1 << 13, 1 << 9):
        _assert_counts_equal(want, jks.count_kmers_streaming(
            reads, 31, 2, chunk_bases=4096, device_rows_budget=budget))
    pks.PROF.clear()
    got = pks.count_kmers_streaming(reads, 31, 2, chunk_bases=4096,
                                    device_rows_budget=budget, device="cpu")
    _assert_counts_equal(want, got)
    assert ("acc_compact" in pks.PROF) == compacts
    assert ("acc_spill" in pks.PROF) == spills


@pytest.mark.parametrize("n", [3, 8])
def test_streaming_sharded_merge(n):
    """Phase 2 over a CPU mesh, one prefix partition a shard with no
    collective, equal to the JAX package's sharded count (its 8-device
    CPU mesh) and to one device's."""
    from haslr_tpu.dist.mesh import make_mesh as jax_mesh

    reads = _random_reads(5, 150, poly_t=70)
    want = jk.count_kmers_host(_with_seps(reads), 31, 2)
    _assert_counts_equal(want, jks.count_kmers_streaming(
        reads, 31, 2, chunk_bases=8192, prefix_bits=3, mesh=jax_mesh(n)))
    pks.PROF.clear()
    got = pks.count_kmers_streaming(reads, 31, 2, chunk_bases=8192,
                                    prefix_bits=3,
                                    mesh=make_mesh(n, device="cpu"))
    _assert_counts_equal(want, got)
    assert "phase1_acc" not in pks.PROF  # the host store's regime


def test_streaming_edge_inputs():
    """No reads, reads shorter than k only, and one read longer than a
    chunk."""
    z = jk.count_kmers_host(np.zeros(0, np.uint8), 21)
    for reads in ([], [np.zeros(10, np.uint8)] * 3):
        _assert_counts_equal(z, pks.count_kmers_streaming(
            reads, 21, device="cpu"))
    rng = np.random.default_rng(8)
    reads = [rng.integers(0, 4, 5000).astype(np.uint8),
             rng.integers(0, 4, 30).astype(np.uint8)]
    _assert_counts_equal(
        jk.count_kmers_host(_with_seps(reads), 21),
        pks.count_kmers_streaming(reads, 21, chunk_bases=1024,
                                  device="cpu"))


# --------------------------------------------------------------------------
# the short-read stage and assemble_unitigs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sr_reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_kmer_sr")
    rng = np.random.default_rng(11)
    genome = simulate.genome_with_repeats(
        rng, 12_000, n_families=2, copies_per_family=3, repeat_len=300
    )
    sr = str(root / "sr.fq")
    simulate.write_short_reads(sr, simulate.make_short_reads(
        rng, genome, coverage=30.0))
    return sr


@pytest.fixture(scope="module")
def sr_reference(sr_reads, tmp_path_factory):
    """The JAX package's SR contigs by its native counter; every counting
    engine gives these bytes there."""
    from haslr_tpu.sr.assemble_sr import assemble_short_reads

    path = tmp_path_factory.mktemp("torch_kmer_sr_ref") / "ref.fa"
    assemble_short_reads([sr_reads], str(path), kmer_size=49)
    return path.read_bytes()


@pytest.mark.parametrize("engine", [
    "streaming", "device", "numpy", "no_native",
])
def test_assemble_short_reads_every_counter(sr_reads, sr_reference,
                                            tmp_path, monkeypatch, engine):
    """Every counting branch of ``assemble_short_reads`` writes the JAX
    package's SR contigs; without the native library the stage takes the
    device counter (the reference's selection), here on the CPU."""
    from haslr_tpu.sr import assemble_sr as jsr
    from haslr_tpu_torch.sr import assemble_sr

    kw = {"streaming": engine == "streaming"} if engine != "no_native" \
        else {}
    if engine == "numpy":
        kw["device"] = False
    if engine == "no_native":
        monkeypatch.setattr(assemble_sr, "_count_native",
                            lambda *a: None)
    path = tmp_path / "port.fa"
    assemble_sr.assemble_short_reads([sr_reads], str(path), kmer_size=49,
                                     torch_device="cpu", **kw)
    assert path.read_bytes() == sr_reference
    assert "count_engine" not in assemble_sr.PROF
    assert any(k.startswith("count.phase1") for k in assemble_sr.PROF) == \
        (engine == "streaming")
    if engine == "streaming":
        ref = tmp_path / "ref.fa"
        jsr.assemble_short_reads([sr_reads], str(ref), kmer_size=49,
                                 streaming=True)
        assert ref.read_bytes() == sr_reference


def test_assemble_short_reads_counts_on_the_card_by_default(sr_reads,
                                                           tmp_path):
    from haslr_tpu_torch.sr import assemble_sr

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for kw in ({"streaming": True}, {"streaming": False}):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            assemble_sr.assemble_short_reads(
                [sr_reads], str(tmp_path / "x.fa"), kmer_size=49, **kw)


def test_cli_counts_on_the_run_device(sr_reads, sr_reference, tmp_path,
                                      monkeypatch):
    """The CLI's SR stage hands the run's device (``--device cpu``) to
    the device counters, so a CPU run never asks for the card."""
    from haslr_tpu_torch.cli import haslr as cli
    from haslr_tpu_torch.sr import assemble_sr

    monkeypatch.setattr(assemble_sr, "_count_native", lambda *a: None)
    lr = tmp_path / "lr.fa"
    lr.write_text(">1\nACGT\n")
    cfg, device = cli.parse_options(
        ["-o", str(tmp_path), "-g", "12k", "-l", str(lr), "-x", "pacbio",
         "-s", sr_reads, "--device", "cpu"])
    out = cli.assemble_srs(cfg, cli._get_mesh(cfg, device))
    with open(out, "rb") as f:
        assert f.read() == sr_reference


@pytest.mark.parametrize("device", [True, False])
def test_assemble_unitigs_matches_reference(device):
    from haslr_tpu.sr import dbg as jdbg
    from haslr_tpu_torch.sr import dbg

    rng = np.random.default_rng(2)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 2000))
    codes = np.concatenate(
        [cseq.encode(genome), [4], cseq.encode(genome[300:1500]), [4]]
    ).astype(np.uint8)
    want = jdbg.assemble_unitigs(codes, 31, 2, device=device)
    got = dbg.assemble_unitigs(codes, 31, 2, device=device,
                               torch_device="cpu")
    assert [(u.seq, u.kc, u.links) for u in got] == \
        [(u.seq, u.kc, u.links) for u in want]
    assert len(got) == 1 and got[0].seq in (
        genome[300:1500], cseq.revcomp(genome[300:1500]))
