"""The port's row-scan plain versions against the JAX package: XLA dirs
and mapping, the Pallas vote-plane and CIGAR-run kernels (interpret
mode), and the mapping + scatter vote tables.  Same seeded numpy inputs
to both; every comparison is exact integer equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haslr_tpu.kernels import consensus_dense as cd
from haslr_tpu.kernels import nw_rowscan as rs
from haslr_tpu_torch.kernels import consensus_dense as pcd
from haslr_tpu_torch.kernels import nw_rowscan as prs

from test_nw_rowscan import _mutated_batch

WIDTHS = (128, 256, 512)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(seed, B, S, W):
    """A mutated batch with two out-of-gate rows and pure padding rows,
    as (jax args, torch args, numpy arrays)."""
    rng = np.random.default_rng(seed)
    reads, r_lens, drafts, d_lens = _mutated_batch(rng, B, S)
    r_lens[0] = min(int(r_lens[0]), 60)
    d_lens[0] = 60 + W
    r_lens[1], d_lens[1] = d_lens[1], r_lens[1]
    arrays = (reads, r_lens, drafts, d_lens)
    return (
        tuple(jnp.asarray(a) for a in arrays),
        tuple(torch.from_numpy(a) for a in arrays),
        arrays,
    )


def _in_gate(r_lens, d_lens, W):
    return (r_lens > 0) & (d_lens > 0) & (np.abs(r_lens - d_lens) < W // 2 - 4)


@pytest.mark.parametrize("W", WIDTHS)
def test_plain_dirs_and_mapping_match_xla(W):
    S = 2 * W
    ja, ta, _ = _batch(W, 16, S, W)
    dirs = rs._rowscan_dirs_inner(*ja, S, S, W, 5, -4, -8)
    np.testing.assert_array_equal(
        np.asarray(dirs), prs.rowscan_dirs_plain(*ta, W, 5, -4, -8).numpy()
    )
    mapping = rs._rowscan_mapping_inner(*ja, S, S, W, 5, -4, -8)
    np.testing.assert_array_equal(
        np.asarray(mapping),
        prs.rowscan_mapping_plain(*ta, W, 5, -4, -8).numpy(),
    )


def test_plain_votes_match_pallas_interpret():
    """Planes and span on in-gate rows (the Pallas kernel drops writes
    outside its 2W windows on out-of-gate rows; the vote tables never read
    those rows)."""
    B, S, W = 64, 256, 128
    ja, ta, (_r, r_lens, _d, d_lens) = _batch(5, B, S, W)
    planes, stats = rs.rowscan_votes_pallas(*ja, S, S, W, 5, -4, -8, True)
    got_p, got_s = prs.rowscan_votes(*ta, W, 5, -4, -8)
    ok = _in_gate(r_lens, d_lens, W)
    assert ok.sum() > B // 2
    np.testing.assert_array_equal(np.asarray(planes)[ok], got_p.numpy()[ok])
    np.testing.assert_array_equal(np.asarray(stats)[ok, :2],
                                  got_s.numpy()[ok])


def _window_batch(seed, B, S, W, N=8):
    """Reads mutated from N window drafts (the reference vote-table
    test's construction)."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, S), 4, np.uint8)
    drafts_n = np.full((N, S), 4, np.uint8)
    d_lens_n = np.zeros(N, np.int32)
    for n in range(N):
        dl = int(rng.integers(S // 4, S - 10))
        drafts_n[n, :dl] = rng.integers(0, 4, dl)
        d_lens_n[n] = dl
    win_idx = rng.integers(0, N, B).astype(np.int32)
    r_lens = np.zeros(B, np.int32)
    for b in range(B - 4):
        d = drafts_n[win_idx[b]][: d_lens_n[win_idx[b]]]
        r = []
        for ch in d:
            x = rng.random()
            if x < 0.04:
                continue
            if x < 0.10:
                r.append(int(rng.integers(0, 4)))
            if x < 0.14:
                r.append(int(rng.integers(0, 4)))
                continue
            r.append(int(ch))
        r = np.array(r[:S], np.uint8)
        reads[b, : len(r)] = r
        r_lens[b] = len(r)
    dl_r = d_lens_n[win_idx]
    return reads, r_lens, drafts_n[win_idx], dl_r, win_idx, N


@pytest.mark.parametrize("W", WIDTHS)
def test_vote_tables_match_mapping_scatter(W):
    """Port: plain vote planes reduced with index_add_.  Reference: XLA
    row-scan mapping + ``consensus_dense._scatter_votes``."""
    S = 2 * W
    B = 32
    reads, r_lens, dr_r, dl_r, win_idx, N = _window_batch(W + 1, B, S, W)
    ok = _in_gate(r_lens, dl_r, W)
    ja = tuple(jnp.asarray(a) for a in (reads, r_lens, dr_r, dl_r))
    mapping = rs._rowscan_mapping_inner(*ja, S, S, W, 5, -4, -8)
    ref = cd._scatter_votes(mapping, ja[0], ja[1], jnp.asarray(win_idx),
                            jnp.asarray(ok), N, S)
    ta = tuple(torch.from_numpy(a) for a in (reads, r_lens, dr_r, dl_r))
    planes, stats = prs.rowscan_votes(*ta, W, 5, -4, -8)
    got = pcd._vote_tables(planes, stats, torch.from_numpy(win_idx).long(),
                           torch.from_numpy(ok), N, S)
    for name, a, b in zip(("counts", "cov_diff", "ins1", "ins2", "n_reads"),
                          ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)


def _emitted(runs, n, maxr):
    m = np.arange(maxr)[None, :] < np.minimum(n, maxr)[:, None]
    return runs[m]


@pytest.mark.parametrize("W", WIDTHS)
def test_plain_cigar_matches_xla(W):
    S = 2 * W
    maxr = max(128, S // 4)
    ja, ta, _ = _batch(W + 2, 16, S, W)
    runs_x, n_x = rs._rowscan_cigar_inner(*ja, S, S, W, 2, -4, -2, maxr)
    runs_p, n_p = prs.rowscan_cigar(*ta, W, 2, -4, -2, maxr)
    n_x = np.asarray(n_x)
    np.testing.assert_array_equal(n_x, n_p.numpy())
    np.testing.assert_array_equal(_emitted(np.asarray(runs_x), n_x, maxr),
                                  _emitted(runs_p.numpy(), n_x, maxr))


def test_plain_cigar_matches_pallas_interpret():
    B, S, W, maxr = 64, 256, 128, 128
    ja, ta, _ = _batch(19, B, S, W)
    runs_k, cnt_k = rs.rowscan_cigar_pallas(*ja, S, S, W, 2, -4, -2, maxr,
                                            True)
    runs_p, n_p = prs.rowscan_cigar_plain(*ta, W, 2, -4, -2, maxr)
    n_k = np.asarray(cnt_k)[:, 0]
    np.testing.assert_array_equal(n_k, n_p.numpy())
    np.testing.assert_array_equal(_emitted(np.asarray(runs_k), n_k, maxr),
                                  _emitted(runs_p.numpy(), n_k, maxr))


def test_cigar_overflow_flagged():
    """Reads needing more runs than MAXR report their true count, equal
    to the reference's, so the caller can realign them on host."""
    B, S, W, maxr = 16, 256, 128, 64
    rng = np.random.default_rng(23)
    reads = np.full((B, S), 4, np.uint8)
    drafts = np.full((B, S), 4, np.uint8)
    r_lens = np.zeros(B, np.int32)
    d_lens = np.full(B, 150, np.int32)
    for b in range(B):
        d = rng.integers(0, 4, 150).astype(np.uint8)
        r = []
        for p, ch in enumerate(d):
            r.append(int(ch))
            if p % 2 == 0 and p < 80:
                r.append(int(rng.integers(0, 4)))
        reads[b, : len(r)] = r
        drafts[b, :150] = d
        r_lens[b] = len(r)
    arrays = (reads, r_lens, drafts, d_lens)
    runs_x, n_x = rs._rowscan_cigar_inner(
        *(jnp.asarray(a) for a in arrays), S, S, W, 2, -4, -2, maxr
    )
    runs_p, n_p = prs.rowscan_cigar(
        *(torch.from_numpy(a) for a in arrays), W, 2, -4, -2, maxr
    )
    n_x = np.asarray(n_x)
    np.testing.assert_array_equal(n_x, n_p.numpy())
    assert (n_x > maxr).any()
    np.testing.assert_array_equal(_emitted(np.asarray(runs_x), n_x, maxr),
                                  _emitted(runs_p.numpy(), n_x, maxr))


def test_cigar_runs_device_raw_shapes():
    _ja, _ta, arrays = _batch(3, 8, 512, 128)
    runs, n_runs = prs.cigar_runs_device_raw(*arrays, W=128)
    assert runs.shape == (8, 128) and runs.dtype == torch.int32
    assert n_runs.shape == (8,) and n_runs.dtype == torch.int32
    assert (n_runs[:4] > 0).all()


def test_row_bases_match_reference():
    for R, D, W in ((128, 128, 128), (512, 512, 128), (2048, 2048, 256),
                    (300, 4096, 512)):
        np.testing.assert_array_equal(prs.row_bases(R, D, W),
                                      rs.row_bases(R, D, W))
        assert prs.rowscan_supported(R, D, W) == rs.rowscan_supported(R, D, W)


@pytest.mark.parametrize("entry", ["dirs", "mapping", "votes", "cigar",
                                   "mapping_wrapper"])
def test_unsupported_band_raises(entry):
    """D > R with band steps above one column per row is refused, never
    computed wrong (the reference never checked)."""
    R, D, W = 128, 512, 128
    assert not prs.rowscan_supported(R, D, W)
    args = (torch.full((2, R), 4, dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int32),
            torch.full((2, D), 4, dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int32), W, 5, -4, -8)
    fn = {
        "dirs": prs.rowscan_dirs_plain,
        "mapping": prs.rowscan_mapping_plain,
        "votes": prs.rowscan_votes,
        "cigar": lambda *a: prs.rowscan_cigar(*a, 128),
        "mapping_wrapper": prs.rowscan_mapping,
    }[entry]
    with pytest.raises(ValueError, match="unsupported"):
        fn(*args)


def test_wrappers_count_no_launch_on_cpu():
    before = dict(prs.LAUNCHES)
    _ja, ta, _ = _batch(4, 8, 256, 128)
    prs.rowscan_votes(*ta, 128, 5, -4, -8)
    prs.rowscan_cigar(*ta, 128, 2, -4, -2, 128)
    prs.rowscan_mapping(*ta, 128, 5, -4, -8)
    assert prs.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; tensors elsewhere that are
    not CUDA tensors are refused, not computed on the CPU."""
    _ja, ta, _ = _batch(4, 4, 256, 128)
    meta = [t.to("meta") for t in ta]
    with pytest.raises(ValueError, match="unsupported device"):
        prs.rowscan_votes(*meta, 128, 5, -4, -8)
    with pytest.raises(ValueError, match="unsupported device"):
        prs.rowscan_cigar(*meta, 128, 2, -4, -2, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        prs.rowscan_mapping(*meta, 128, 5, -4, -8)


def test_mapping_wrapper_matches_pallas_interpret():
    """B3's wrapper on the CPU (its plain version) against the Pallas
    mapping kernel in interpret mode, every row, int32 like the kernel."""
    B, S, W = 64, 256, 128
    ja, ta, _ = _batch(29, B, S, W)
    ref = rs.rowscan_mapping_pallas(*ja, S, S, W, 2, -4, -2, True)
    got = prs.rowscan_mapping(*ta, W, 2, -4, -2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    """A compiler that fails makes the first kernel build raise with its
    stderr, and leaves no library behind to be loaded later."""
    from haslr_tpu_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'rowscan.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "_state", {})
    with pytest.raises(RuntimeError, match="(?s)exit 2.*boom"):
        _build.lib()
    assert not list(build_dir.glob("*.so"))
    assert "lib" not in _build._state
