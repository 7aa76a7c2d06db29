"""The port's dense consensus engine and assembler against the JAX
package: window-for-window consensus on bench-style and oversized
windows, under the default row-scan engine and the wavefront engine, the
pinned golden assembly, and resume from snapshots written by
``haslr_tpu``.  Exact equality throughout."""

import gzip
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from haslr_tpu.core import seq as cseq
from haslr_tpu.kernels import consensus_dense as cd
from haslr_tpu.kernels import nw
from haslr_tpu_torch.kernels import consensus_dense as pcd
from haslr_tpu_torch.kernels import nw as pnw

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
sys.path.insert(0, GOLDEN)

from make_golden import GOLDEN_ARTIFACTS  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def wavefront(monkeypatch):
    """Both packages on the wavefront engine for one test, restored after
    it (the module global would otherwise leak into later tests)."""
    monkeypatch.setattr(nw, "ENGINE", "wavefront")
    monkeypatch.setattr(pnw, "ENGINE", "wavefront")


def _mutate(rng, s, err):
    out = []
    for ch in s:
        r = rng.random()
        if r < err / 3:
            continue
        if r < 2 * err / 3:
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(ch))
            if r < err:
                out.append(int(rng.integers(0, 4)))
    return np.array(out, np.uint8)


def _windows(seed, lengths, n_support, err):
    rng = np.random.default_rng(seed)
    wins = []
    for L in lengths:
        true = rng.integers(0, 4, L).astype(np.uint8)
        wins.append([_mutate(rng, true, err) for _ in range(n_support)])
    return wins


def _assert_same(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, f"window {i}")


def test_dense_consensus_matches_reference_bench_windows():
    """Bench-style windows (13 reads, ~300 bp, 6 % error) in the
    S=512/W=128 bucket, plus shorter and longer windows that reach the
    S=128, 256 and 2048 (W=256) buckets, an empty window and a
    single-read window."""
    rng = np.random.default_rng(0)
    lengths = [int(x) for x in rng.integers(200, 400, 12)]
    wins = _windows(1, lengths + [60, 150, 1500], 13, 0.06)
    wins += [[], [cseq.encode("ACGTACGT")]]
    _assert_same(cd.dense_consensus(wins),
                 pcd.dense_consensus(wins, device="cpu"))


@pytest.fixture
def small_buckets(monkeypatch):
    """Both packages' bucket tables shrunk the same way, so the
    oversized-window split runs at test scale."""
    for mod in (cd, pcd):
        monkeypatch.setattr(mod, "BUCKETS", (128, 256, 512))
        monkeypatch.setattr(mod, "SEG_TARGET", 300)
        monkeypatch.setattr(mod, "SEG_SEARCH", 64)


def test_dense_consensus_matches_reference_oversized(small_buckets):
    rng = np.random.default_rng(3)
    big = rng.integers(0, 4, 1200).astype(np.uint8)
    huge = rng.integers(0, 4, 1500).astype(np.uint8)
    small = rng.integers(0, 4, 180).astype(np.uint8)
    wins = [
        [_mutate(rng, small, 0.03) for _ in range(7)],
        [],
        [_mutate(rng, big, 0.03) for _ in range(7)],
        [_mutate(rng, huge, 0.04) for _ in range(11)],
    ]
    ref_warn, got_warn = [], []
    ref = cd.dense_consensus(wins, warn=ref_warn.append)
    got = pcd.dense_consensus(wins, warn=got_warn.append, device="cpu")
    _assert_same(ref, got)
    assert any("split into" in w for w in got_warn)
    assert [w for w in ref_warn if "split" in w] == \
        [w for w in got_warn if "split" in w]


def _engines_agree_windows():
    """The windows of ``test_nw_rowscan.test_consensus_engines_agree``."""
    rng = np.random.default_rng(23)
    bases = "ACGT"

    def mutate(s, rate=0.07):
        out = []
        for ch in s:
            r = rng.random()
            if r < rate / 3:
                continue
            if r < 2 * rate / 3:
                out.append(bases[rng.integers(0, 4)])
            else:
                out.append(ch)
                if r < rate:
                    out.append(bases[rng.integers(0, 4)])
        return "".join(out)

    windows = []
    for L in (60, 200, 500, 900):
        true = "".join(bases[i] for i in rng.integers(0, 4, L))
        windows.append([mutate(true) for _ in range(9)])
    return windows + [[], ["ACGT"]]


def test_dense_consensus_matches_reference_wavefront(wavefront):
    """Under the wavefront engine (vote planes from B4's plain version):
    the bench-style windows of the row-scan test above and the windows of
    the reference's engine-agreement test, against the JAX package under
    the same engine."""
    from haslr_tpu.kernels.consensus import batched_consensus
    from haslr_tpu_torch.kernels.consensus import (
        batched_consensus as p_batched,
    )

    rng = np.random.default_rng(0)
    lengths = [int(x) for x in rng.integers(200, 400, 12)]
    wins = _windows(1, lengths + [60, 150, 1500], 13, 0.06)
    _assert_same(cd.dense_consensus(wins),
                 pcd.dense_consensus(wins, device="cpu"))
    windows = _engines_agree_windows()
    assert batched_consensus(windows) == p_batched(windows, device="cpu")


def test_pack2_and_unpack_roundtrip():
    from haslr_tpu.kernels.kmer_stream import pack2

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    packed = pcd.pack2(codes)
    np.testing.assert_array_equal(packed, pack2(codes))
    rows = pcd._unpack_rows(
        torch.from_numpy(packed), torch.tensor([0, 5, 1000]),
        torch.tensor([5, 995, 1]), 1000,
    ).numpy()
    np.testing.assert_array_equal(rows[0, :5], codes[:5])
    np.testing.assert_array_equal(rows[1, :995], codes[5:1000])
    assert rows[2, 0] == codes[1000] and (rows[2, 1:] == 4).all()
    assert (rows[0, 5:] == 4).all()


def _golden_inputs(tmp_path):
    paths = []
    for name in ("contigs.fa", "lr.fa", "map.paf"):
        dst = str(tmp_path / name)
        with gzip.open(f"{GOLDEN}/input/{name}.gz", "rb") as fi, \
                open(dst, "wb") as fo:
            fo.write(fi.read())
        paths.append(dst)
    return paths


def _assert_golden(out_dir, prefix):
    """The stage artifacts (graph build and cleaning cascade, the same
    for either engine) and the final assembly ``{prefix}asm.final.*``."""
    final = ("asm.final.fa", "asm.final.ann")
    stages = [n for n in GOLDEN_ARTIFACTS if n not in final]
    for want_name, name in [(n, n) for n in stages] + \
            [(prefix + n, n) for n in final]:
        with open(f"{GOLDEN}/expected/{want_name}", "rb") as f:
            want = f.read()
        with open(f"{out_dir}/{name}", "rb") as f:
            assert f.read() == want, name


@pytest.mark.parametrize("engine,prefix", [("tpu", "tpu."), ("poa", "")])
def test_run_assembler_reproduces_golden(tmp_path, engine, prefix):
    """The port's run_assembler on the golden input: every pinned stage
    artifact, and the final assembly of the device engine ("tpu",
    ``tpu.asm.final.{fa,ann}``) or the host POA engine
    (``asm.final.{fa,ann}``), byte for byte."""
    from haslr_tpu.config import AssembleConfig
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    contigs, lr, paf = _golden_inputs(tmp_path)
    out = str(tmp_path / "asm")
    run_assembler(contigs, lr, paf, out,
                  cfg=AssembleConfig(consensus_engine=engine), log=None,
                  device="cpu")
    _assert_golden(out, prefix)


def test_run_assembler_reproduces_golden_wavefront(tmp_path, wavefront):
    """The device engine's golden ``tpu.asm.final.{fa,ann}`` come out byte
    for byte under the wavefront engine too (the JAX package does the
    same)."""
    from haslr_tpu.config import AssembleConfig
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    contigs, lr, paf = _golden_inputs(tmp_path)
    out = str(tmp_path / "asm")
    run_assembler(contigs, lr, paf, out,
                  cfg=AssembleConfig(consensus_engine="tpu"), log=None,
                  device="cpu")
    _assert_golden(out, "tpu.")


def test_resume_from_reference_snapshots(tmp_path):
    """index.contig.npz / index.longread.npz written by ``haslr_tpu``
    resume the port's run (the raw inputs are gone) to the same golden
    device-engine output."""
    from haslr_tpu.assemble import index_io
    from haslr_tpu.assemble.contig_store import ContigStore
    from haslr_tpu.assemble.longread_store import (
        LongreadStore,
        load_alignments,
    )
    from haslr_tpu.config import AssembleConfig
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    contigs_p, lr_p, paf_p = _golden_inputs(tmp_path)
    cfg = AssembleConfig(consensus_engine="tpu")
    out = tmp_path / "resumed"
    out.mkdir()
    contigs = ContigStore.load_fasta(contigs_p)
    index_io.write_contig_index(str(out / "index.contig.npz"), contigs)
    lrs = LongreadStore.load_fasta(lr_p)
    load_alignments(paf_p, contigs, lrs, contigs.calc_uniq_freq(), cfg)
    index_io.write_longread_index(str(out / "index.longread.npz"), lrs)
    gone = tmp_path / "gone"
    stats = run_assembler(str(gone / "c.fa"), str(gone / "l.fa"),
                          str(gone / "m.paf"), str(out), cfg=cfg, log=None,
                          device="cpu")
    assert stats["n_alignments"] > 0
    _assert_golden(str(out), "tpu.")
    shutil.rmtree(out)
