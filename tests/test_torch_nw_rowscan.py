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
from haslr_tpu_torch.kernels import nw_rowscan as prs
from haslr_tpu_torch.kernels import vote_tables as pvt

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
    """Port: plain vote planes reduced by ``vote_tables_plain``.
    Reference: XLA row-scan mapping + ``consensus_dense._scatter_votes``."""
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
    got = pvt.vote_tables_plain(planes, stats,
                                torch.from_numpy(win_idx).long(),
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
    runs, n_runs = prs.cigar_runs_device_raw(*arrays, W=128, device="cpu")
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


def _byte_scan(row, lane):
    """``_traceback``'s step on one direction row (the plain version's
    cummax over ``lane << 2 | dir`` of the non-LEFT cells, gathered at
    ``lane``): ``(direction, lane)`` or None for a forced UP."""
    W = row.shape[0]
    if not 0 <= lane < W:
        return None
    lanes = torch.arange(W, dtype=torch.int64)
    r = torch.from_numpy(row.astype(np.int64))
    val = torch.where(r != prs.LEFT, (lanes << 2) | r, -1)
    picked = int(torch.cummax(val, 0).values[lane])
    return None if picked < 0 else (picked & 3, picked >> 2)


@pytest.mark.parametrize("W", WIDTHS)
def test_packed_walk_step_matches_byte_scan(W):
    """The kernels' traceback step on a row packed to two bits a lane
    (mask of the non-LEFT cells, cut at the lane, leading-zero count)
    against the byte scan, on random rows, sparse rows, all-LEFT rows and
    every lane including 0 and out-of-band ones."""
    rng = np.random.default_rng(W)
    rows = [rng.integers(0, 3, W).astype(np.uint8) for _ in range(6)]
    rows.append(np.full(W, prs.LEFT, np.uint8))  # all LEFT
    sparse = np.full(W, prs.LEFT, np.uint8)
    sparse[[0, W // 2 + 3]] = (prs.UP, prs.DIAG)
    rows.append(sparse)
    late = np.full(W, prs.LEFT, np.uint8)  # nothing at or left of most lanes
    late[W - 1] = prs.DIAG
    rows.append(late)
    for row in rows:
        words = prs.pack_dirs_row(row)
        assert words.dtype == np.uint32 and words.shape == (W // 16,)
        unpacked = (words[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
        np.testing.assert_array_equal(unpacked.reshape(-1), row)
        for lane in (-1, *range(W), W, W + 5):
            assert prs.resolve_packed(words, lane) == _byte_scan(row, lane)


def test_band_table_holds_bases_then_step_bits():
    for R, W in ((128, 128), (512, 128), (2048, 256), (1024, 512)):
        table = prs.band_table(R, R, W)
        base = prs.row_bases(R, R, W)
        assert table.dtype == np.int32
        assert len(table) == R + 1 + R // 32 + 1
        np.testing.assert_array_equal(table[: R + 1], base)
        words = table[R + 1 :].view(np.uint32)
        i = np.arange(1, R + 1)
        np.testing.assert_array_equal((words[i >> 5] >> (i & 31)) & 1,
                                      np.diff(base))
        assert (words[0] & 1) == 0


@pytest.mark.parametrize("W,B,want", [
    (128, 2048, (4, 1)),
    (128, 8, (4, 1)),
    (256, 4096, (8, 1)),
    (256, 64, (8, 1)),
    (512, 4096, (16, 1)),
    (512, 32, (4, 4)),
    (32, 2048, (4, 1)),   # a narrower band: the next lane count, masked
    (96, 64, (4, 1)),
    (160, 2048, (8, 1)),
    (320, 4096, (16, 1)),
    (480, 32, (4, 4)),
])
def test_route_by_width_and_launch_size(W, B, want):
    n_sm = 132
    C, wpr, rpb = prs._route(W, B, n_sm)
    assert (C, wpr) == want
    assert 32 * C * wpr in prs.ROUTES and 0 <= 32 * C * wpr - W < 256
    assert 1 <= rpb <= prs.MAX_READS_PER_BLOCK
    assert rpb == 1 or wpr == 1
    # enough reads a block to spread the launch over the SMs, no more
    assert rpb == prs.MAX_READS_PER_BLOCK or rpb * n_sm >= B or wpr > 1
    assert prs._route(W, B, 2 * n_sm)[2] <= rpb


def test_route_refused_and_scratch_size():
    assert prs.packed_bytes(512, 128) == 513 * 32
    assert prs.packed_bytes(16384, 512) == 16385 * 128
    for W in (0, 16, 48, 544, 1024):
        with pytest.raises(ValueError, match="W in 32..512"):
            prs._route(W, 64, 132)


@pytest.mark.parametrize("R,D", [(512, 512), (510, 509), (301, 300),
                                 (1023, 1021)])
def test_word_rows_pads_to_multiples_of_four(R, D):
    """What the kernels are given for code rows of any width: rows a
    multiple of four wide, padded with code 4, the lengths kept (a read
    longer than R stays longer than the padded row), and a band table of
    (R, D, W) laid out for the padded rows."""
    rng = np.random.default_rng(R)
    B = 5
    reads = torch.from_numpy(rng.integers(0, 4, (B, R)).astype(np.uint8))
    drafts = torch.from_numpy(rng.integers(0, 4, (B, D)).astype(np.uint8))
    r_lens = torch.tensor([0, 7, R, R + 1, R + 9], dtype=torch.int32)
    rk, lk, dk = prs._word_rows(reads, r_lens, drafts)
    Rk, Dk = rk.shape[1], dk.shape[1]
    assert (Rk % 4, Dk % 4) == (0, 0) and 0 <= Rk - R < 4 and 0 <= Dk - D < 4
    if (Rk, Dk) == (R, D):
        assert rk is reads and dk is drafts and lk is r_lens
    assert torch.equal(rk[:, :R], reads) and bool((rk[:, R:] == 4).all())
    assert torch.equal(dk[:, :D], drafts) and bool((dk[:, D:] == 4).all())
    assert lk.dtype == torch.int32 and torch.equal(lk[:3], r_lens[:3])
    assert bool((lk[3:] > Rk).all())
    W = 96
    table = prs.band_table(R, D, W, Rk)
    base = prs.row_bases(R, D, W)
    assert len(table) == Rk + 1 + Rk // 32 + 1
    np.testing.assert_array_equal(table[: R + 1], base)
    assert (table[R + 1 : Rk + 1] == base[R]).all()
    words = table[Rk + 1 :].view(np.uint32)
    i = np.arange(1, Rk + 1)
    np.testing.assert_array_equal((words[i >> 5] >> (i & 31)) & 1,
                                  np.diff(table[: Rk + 1]))
