"""The port's device extension and read mapper against the JAX package:
per-segment CIGARs across the W = 128 / 256 / 512 buckets, under the
row-scan engine (CIGAR runs) and the wavefront engine (the mapping
branch), the host fallbacks and the MAXR overflow fallback,
byte-identical PAF, and the check of the records written."""

import numpy as np
import pytest
import torch

from haslr_tpu.aligner import extend as ext
from haslr_tpu.aligner import map as amap
from haslr_tpu.core import io as cio
from haslr_tpu.core import seq as cseq
from haslr_tpu.kernels import nw
from haslr_tpu_torch.aligner import extend as pext
from haslr_tpu_torch.aligner import map as pmap
from haslr_tpu_torch.kernels import nw as pnw


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _noisy(rng, t, err):
    q = []
    for ch in t:
        x = rng.random()
        if x < err / 2:
            continue
        if x < err:
            q.append(int(rng.integers(0, 4)))
        q.append(int(ch))
    return np.array(q, np.uint8)


def _indel_dense(rng, L):
    """An insertion after every 4th base and a deletion two bases later:
    far more CIGAR runs than MAXR = max(128, S/4) allows."""
    t = rng.integers(0, 4, L).astype(np.uint8)
    q = []
    for p, ch in enumerate(t):
        if p % 4 == 2:
            continue
        q.append(int(ch))
        if p % 4 == 0:
            q.append(int(rng.integers(0, 4)))
    return np.array(q, np.uint8), t


def _segments():
    rng = np.random.default_rng(31)
    segs = []
    for lo, hi, n in ((20, 120, 6), (130, 1000, 8), (1100, 2000, 3),
                      (2100, 3000, 2)):
        for _ in range(n):
            t = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
            segs.append((_noisy(rng, t, 0.06), t))
    segs.append(_indel_dense(rng, 400))
    segs.append(_indel_dense(rng, 600))
    t = rng.integers(0, 4, 300).astype(np.uint8)
    segs.append((t[:200], t))  # band-incompatible: host NW
    segs.append((np.zeros(0, np.uint8), t[:4]))
    segs.append((t[:10], t[:12]))
    return segs


def test_batch_align_segments_matches_reference():
    segs = _segments()
    ref = ext.batch_align_segments(segs)
    got = pext.batch_align_segments(segs, device="cpu")
    assert pext.PROF.get("n_runs_overflow", 0) >= 2
    for i, ((ro, rl, rn), (go, gl, gn)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(ro, go, f"ops {i}")
        np.testing.assert_array_equal(rl, gl, f"lens {i}")
        assert rn == gn, i


def test_batch_align_segments_matches_reference_wavefront(monkeypatch):
    """The mapping branch: under the wavefront engine both packages align
    through the (B, S) mapping (B5's plain version here) and decode it on
    host; segment for segment the same (ops, lens, n_eq)."""
    monkeypatch.setattr(nw, "ENGINE", "wavefront")
    monkeypatch.setattr(pnw, "ENGINE", "wavefront")
    segs = _segments()
    ref = ext.batch_align_segments(segs)
    got = pext.batch_align_segments(segs, device="cpu")
    assert "n_runs_overflow" not in pext.PROF
    assert pext.PROF["collect_d2h"] >= 0
    for i, ((ro, rl, rn), (go, gl, gn)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(ro, go, f"ops {i}")
        np.testing.assert_array_equal(rl, gl, f"lens {i}")
        assert rn == gn, i


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _mutate_str(rng, s, err):
    return cseq.decode(_noisy(rng, cseq.encode(s), err))


@pytest.mark.parametrize("read_type,err,threads",
                         [("nanopore", 0.0, 1), ("pacbio", 0.06, 2)])
def test_map_reads_paf_identical(tmp_path, read_type, err, threads):
    """Contigs cut from one genome, reads drawn across the cut (exact
    reads as in ``test_aligner.py``, and 6 % error reads through the
    HPC preset and two seeding workers)."""
    rng = np.random.default_rng(6)
    genome = _rand_seq(rng, 6000)
    contigs = str(tmp_path / "c.fa")
    reads = str(tmp_path / "r.fa")
    cio.write_fasta(contigs, [("0", genome[:2900]), ("1", genome[3100:])])
    recs = []
    for i in range(8):
        s = int(rng.integers(0, 3500))
        recs.append((str(i), _mutate_str(rng, genome[s : s + 2400], err)))
    cio.write_fasta(reads, recs)
    ref_paf = str(tmp_path / "ref.paf")
    got_paf = str(tmp_path / "got.paf")
    n_ref = amap.map_reads(contigs, reads, ref_paf, read_type=read_type)
    n_got = pmap.map_reads(contigs, reads, got_paf, read_type=read_type,
                           threads=threads, device="cpu")
    assert n_ref == n_got >= 8
    with open(ref_paf, "rb") as f, open(got_paf, "rb") as g:
        assert f.read() == g.read()
    if err:
        assert pmap.PROF["n_segments"] > 0


def test_map_reads_raises_on_short_paf(tmp_path, monkeypatch):
    """A PAF writer that reports more records than reached the file (the
    native writer ignores fwrite/fclose errors) makes the port's
    ``map_reads`` raise, naming the file and both counts."""
    rng = np.random.default_rng(8)
    genome = _rand_seq(rng, 4000)
    contigs = str(tmp_path / "c.fa")
    reads = str(tmp_path / "r.fa")
    cio.write_fasta(contigs, [("0", genome[:1900]), ("1", genome[2100:])])
    cio.write_fasta(reads, [(str(i), genome[s : s + 1500])
                            for i, s in enumerate((0, 600, 1300, 2400))])

    def short_write(pending, seg_results, names, codes, out_paf):
        n = amap._emit_all(pending, seg_results, names, codes, out_paf)
        with open(out_paf, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        with open(out_paf, "wb") as f:
            f.writelines(lines[:-1])
        return n

    paf = str(tmp_path / "out.paf")
    n = pmap.map_reads(contigs, reads, paf, read_type="nanopore",
                       device="cpu")
    assert n >= 4 and pmap.count_records(paf) == n
    monkeypatch.setattr(pmap, "_emit_all", short_write)
    with pytest.raises(OSError, match=f"out.paf.*reported {n} records.*"
                                      f"holds {n - 1}"):
        pmap.map_reads(contigs, reads, paf, read_type="nanopore",
                       device="cpu")
