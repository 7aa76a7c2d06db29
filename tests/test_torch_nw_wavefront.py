"""The port's wavefront engine against the JAX package: the plain versions
of the three wavefront kernels against the XLA scan and traceback (every
cell) and the Pallas kernels in interpret mode, the vote tables against
the XLA mapping + scatter, the ``nw`` entry points under both engines,
and the wrappers' checks.  Same seeded numpy inputs to both; every
comparison is exact integer equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haslr_tpu.kernels import consensus_dense as cd
from haslr_tpu.kernels import nw
from haslr_tpu.kernels import nw_pallas
from haslr_tpu_torch.kernels import nw as pnw
from haslr_tpu_torch.kernels import nw_rowscan as prs
from haslr_tpu_torch.kernels import nw_wavefront as pwf
from haslr_tpu_torch.kernels import vote_tables as pvt

from test_torch_nw_rowscan import _batch, _in_gate, _window_batch


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def engine(request, monkeypatch):
    """Both packages' ``nw.ENGINE`` set for one test and restored after
    it (the global would otherwise leak into later tests of the worker)."""
    monkeypatch.setattr(nw, "ENGINE", request.param)
    monkeypatch.setattr(pnw, "ENGINE", request.param)
    return request.param


def _valid_cells(S, W, r_lens, d_lens):
    """(T+1, B, W) mask of the DP cells inside both sequences."""
    base = pwf.band_bases(S, S, W)
    t = np.arange(2 * S + 1)[:, None, None]
    j = base[:, None, None] + np.arange(W)[None, None, :]
    i = t - j
    return ((i >= 0) & (i <= r_lens[None, :, None])
            & (j <= d_lens[None, :, None]))


def test_band_bases_match_reference():
    for R, D, W in ((128, 128, 128), (512, 512, 128), (2048, 2048, 256),
                    (300, 4096, 512), (4096, 300, 512)):
        np.testing.assert_array_equal(pwf.band_bases(R, D, W),
                                      nw.band_bases(R, D, W))


@pytest.mark.parametrize("W", (128, 256))
def test_plain_dirs_match_xla(W):
    """Every cell, valid or not, in and out of the admission gate."""
    S = 2 * W
    ja, ta, _ = _batch(W, 16, S, W)
    ref = nw._nw_scan(*ja, S, S, W, 5, -4, -8)
    got = pwf.wavefront_dirs(*ta, W, 5, -4, -8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_plain_dirs_match_pallas_interpret():
    """On valid cells (the Pallas kernel computes invalid lanes from
    unmasked candidates and wrapped windows)."""
    B, S, W = 64, 256, 128
    ja, ta, (_r, r_lens, _d, d_lens) = _batch(1, B, S, W)
    ref = np.asarray(nw_pallas.nw_dirs_pallas(*ja, S, S, W, 5, -4, -8,
                                              True))
    got = pwf.wavefront_dirs_plain(*ta, W, 5, -4, -8).numpy()
    valid = _valid_cells(S, W, r_lens, d_lens)
    assert valid.sum() > B * S
    np.testing.assert_array_equal(ref[valid], got[valid])


@pytest.mark.parametrize("W", (128, 256, 512))
def test_plain_mapping_matches_xla(W):
    S = 2 * W
    ja, ta, _ = _batch(W + 3, 16, S, W)
    ref = nw._align_mapping(*ja, S, S, W, 2, -4, -2, False, "wavefront")
    got = pwf.wavefront_mapping(*ta, W, 2, -4, -2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_plain_mapping_matches_pallas_interpret():
    B, S, W = 64, 256, 128
    ja, ta, _ = _batch(7, B, S, W)
    ref = nw_pallas.nw_mapping_pallas(*ja, S, S, W, 2, -4, -2, True)
    got = pwf.wavefront_mapping_plain(*ta, W, 2, -4, -2)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_plain_votes_match_pallas_interpret():
    """Planes and span on in-gate rows (the Pallas kernel drops writes
    outside its 2W windows on out-of-gate rows; the vote tables never read
    those rows)."""
    B, S, W = 64, 256, 128
    ja, ta, (_r, r_lens, _d, d_lens) = _batch(5, B, S, W)
    planes, stats = nw_pallas.nw_votes_pallas(*ja, S, S, W, 5, -4, -8, True)
    got_p, got_s = pwf.wavefront_votes(*ta, W, 5, -4, -8)
    ok = _in_gate(r_lens, d_lens, W)
    assert ok.sum() > B // 2
    np.testing.assert_array_equal(np.asarray(planes)[ok], got_p.numpy()[ok])
    np.testing.assert_array_equal(np.asarray(stats)[ok, :2],
                                  got_s.numpy()[ok])


@pytest.mark.parametrize("W", (128, 256, 512))
def test_vote_tables_match_mapping_scatter(W):
    """Port: wavefront vote planes reduced by ``vote_tables_plain``.
    Reference: XLA wavefront mapping + ``consensus_dense._scatter_votes``."""
    S = 2 * W
    reads, r_lens, dr_r, dl_r, win_idx, N = _window_batch(W + 5, 32, S, W)
    ok = _in_gate(r_lens, dl_r, W)
    ja = tuple(jnp.asarray(a) for a in (reads, r_lens, dr_r, dl_r))
    mapping = nw._align_mapping(*ja, S, S, W, 5, -4, -8, False, "wavefront")
    ref = cd._scatter_votes(mapping, ja[0], ja[1], jnp.asarray(win_idx),
                            jnp.asarray(ok), N, S)
    ta = tuple(torch.from_numpy(a) for a in (reads, r_lens, dr_r, dl_r))
    planes, stats = pwf.wavefront_votes(*ta, W, 5, -4, -8)
    got = pvt.vote_tables_plain(planes, stats,
                                torch.from_numpy(win_idx).long(),
                                torch.from_numpy(ok), N, S)
    for name, a, b in zip(("counts", "cov_diff", "ins1", "ins2", "n_reads"),
                          ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)


@pytest.mark.parametrize(
    "engine,S,W",
    [pytest.param(e, S, W, id=e if S == 256 else f"{e}-S{S}-W{W}")
     for S, W in ((256, 128), (512, 128), (2048, 256))
     for e in ("rowscan", "wavefront")],
    indirect=["engine"])
def test_align_mapping_device_matches_reference(engine, S, W):
    """``align_mapping_device`` under either engine: the same mapping and
    dtype as the JAX function under the same engine (row-scan: B3's
    plain version; wavefront: B5's), at S = 256 and at the bucket shapes
    S = 512 / W = 128 and S = 2048 / W = 256."""
    _ja, _ta, arrays = _batch(17, 16, S, W)
    ref = nw.align_mapping_device(*arrays, W, 2, -4, -2)
    got = pnw.align_mapping_device(*arrays, W, 2, -4, -2, device="cpu")
    assert got.dtype == ref.dtype == np.int16
    np.testing.assert_array_equal(ref, got)


def test_banded_nw_batch_and_traceback_match_reference():
    """The DP-only route (B6 + host traceback) equals the JAX one, and
    equals the fused wavefront mapping (B5) row for row."""
    _ja, _ta, arrays = _batch(13, 16, 256, 128)
    reads, r_lens, drafts, d_lens = arrays
    dirs_r, base_r = nw.banded_nw_batch(*arrays, 128)
    dirs_g, base_g = pnw.banded_nw_batch(*arrays, 128, device="cpu")
    assert dirs_g.dtype == np.uint8 and dirs_g.shape == (513, 16, 128)
    np.testing.assert_array_equal(dirs_r, dirs_g)
    np.testing.assert_array_equal(base_r, base_g)
    m_ref = nw.traceback_batch(dirs_r, base_r, r_lens, d_lens, 256)
    m_got = pnw.traceback_batch(dirs_g, base_g, r_lens, d_lens, 256)
    np.testing.assert_array_equal(m_ref, m_got)
    fused = pwf.wavefront_mapping(*(torch.from_numpy(a) for a in arrays),
                                  128, 5, -4, -8)
    np.testing.assert_array_equal(m_got, fused.numpy())


def test_unknown_engine_raises(monkeypatch):
    monkeypatch.setattr(pnw, "ENGINE", "diagonal")
    _ja, _ta, arrays = _batch(3, 4, 256, 128)
    with pytest.raises(ValueError, match="unknown NW engine"):
        pnw.align_mapping_device(*arrays, 128, device="cpu")


@pytest.mark.parametrize("entry", ["dirs", "mapping", "votes"])
def test_band_step_raises(entry, monkeypatch):
    """A band that advances by more than one column per anti-diagonal is
    refused, never computed wrong: the DP reads its neighbours at lane
    shifts of -1..1 only."""
    real = pwf.band_bases

    def jumpy(R, D, W):
        base = real(R, D, W)
        base[len(base) // 2 :] += 2
        return base

    monkeypatch.setattr(pwf, "band_bases", jumpy)
    _ja, ta, _ = _batch(3, 4, 256, 128)
    fn = {"dirs": pwf.wavefront_dirs, "mapping": pwf.wavefront_mapping,
          "votes": pwf.wavefront_votes}[entry]
    with pytest.raises(ValueError, match="advance by 0 or 1"):
        fn(*ta, 128, 5, -4, -8)


def test_wrappers_count_no_launch_on_cpu():
    before = dict(pwf.LAUNCHES), dict(prs.LAUNCHES)
    _ja, ta, _ = _batch(4, 8, 256, 128)
    pwf.wavefront_dirs(*ta, 128, 5, -4, -8)
    pwf.wavefront_mapping(*ta, 128, 5, -4, -8)
    pwf.wavefront_votes(*ta, 128, 5, -4, -8)
    prs.rowscan_mapping(*ta, 128, 5, -4, -8)
    assert (dict(pwf.LAUNCHES), dict(prs.LAUNCHES)) == before


@pytest.mark.parametrize("entry", ["dirs", "mapping", "votes"])
def test_wrappers_refuse_other_devices(entry):
    """Only CPU tensors take the plain version; tensors elsewhere that are
    not CUDA tensors are refused, not computed on the CPU."""
    _ja, ta, _ = _batch(4, 4, 256, 128)
    meta = [t.to("meta") for t in ta]
    fn = {"dirs": pwf.wavefront_dirs, "mapping": pwf.wavefront_mapping,
          "votes": pwf.wavefront_votes}[entry]
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*meta, 128, 5, -4, -8)


# --------------------------------------------------------------------------
# numpy mirrors of what the CUDA kernels do with bits, held to the plain
# versions; the route, the scratch size and the extension's launch sizes
# --------------------------------------------------------------------------


def _rect_batch(seed, B, R, D):
    """A ``_batch``-style batch (ragged, out-of-gate and pad rows) with
    code rows R and D wide."""
    _ja, _ta, (reads, r_lens, drafts, d_lens) = _batch(seed, B, min(R, D),
                                                       128)
    reads = np.pad(reads, ((0, 0), (0, R - reads.shape[1])),
                   constant_values=4)
    drafts = np.pad(drafts, ((0, 0), (0, D - drafts.shape[1])),
                    constant_values=4)
    return reads, r_lens, drafts, d_lens


@pytest.mark.parametrize("W", (128, 256, 512))
def test_packed_walk_matches_plain_walk(W):
    """The packed diagonal and the packed walk move (``tb_move``'s edge
    rules on two bits a cell) give the mapping of ``_walk`` over the plain
    directions, row for row, at the lanes of every route."""
    B, S = 10, 2 * W
    arrays = _batch(W + 1, B, S, W)[2]
    ta = tuple(torch.from_numpy(a) for a in arrays)
    dirs = pwf.wavefront_dirs_plain(*ta, W, 2, -4, -2).numpy()
    want = pwf.wavefront_mapping_plain(*ta, W, 2, -4, -2).numpy()
    base = pwf.band_bases(S, S, W)
    for C, wpr in pwf.ROUTES[W]:
        assert 32 * C * wpr == W
    for b in range(B):
        words = np.stack([pwf.pack_dirs_diag(row) for row in dirs[:, b, :]])
        assert words.shape == (2 * S + 1, W // 16)
        got = pwf.mapping_from_packed(words, base, W, arrays[1][b],
                                      arrays[3][b], S)
        np.testing.assert_array_equal(got, want[b], f"row {b}")


def test_packed_walk_masked_band():
    """A band of 96 lanes stored on 128: the spare lanes are never read."""
    B, S, W, lanes = 6, 256, 96, 128
    arrays = _batch(5, B, S, W)[2]
    ta = tuple(torch.from_numpy(a) for a in arrays)
    dirs = pwf.wavefront_dirs_plain(*ta, W, 2, -4, -2).numpy()
    want = pwf.wavefront_mapping_plain(*ta, W, 2, -4, -2).numpy()
    base = pwf.band_bases(S, S, W)
    for b in range(B):
        full = np.zeros((2 * S + 1, lanes), np.uint8)  # spare lanes: DIAG
        full[:, :W] = dirs[:, b, :]
        words = np.stack([pwf.pack_dirs_diag(row) for row in full])
        got = pwf.mapping_from_packed(words, base, W, arrays[1][b],
                                      arrays[3][b], S)
        np.testing.assert_array_equal(got, want[b], f"row {b}")


def test_packed_move_edge_rules():
    """Out of band or past t_hi -> LEFT, then i == 0 -> LEFT, then
    j == 0 -> UP, whatever the cell holds."""
    W, S = 128, 256
    base = pwf.band_bases(S, S, W)
    words = np.stack([pwf.pack_dirs_diag(np.full(W, pnw.DIAG))] * (2 * S + 1))
    assert pwf.packed_move(words, base, W, 2 * S, 40, 40) == pnw.DIAG
    assert pwf.packed_move(words, base, W, 60, 40, 40) == pnw.LEFT
    assert pwf.packed_move(words, base, W, 2 * S, 10, 200) == pnw.LEFT
    assert pwf.packed_move(words, base, W, 2 * S, 0, 7) == pnw.LEFT
    assert pwf.packed_move(words, base, W, 2 * S, 7, 0) == pnw.UP
    ups = np.stack([pwf.pack_dirs_diag(np.full(W, pnw.UP))] * (2 * S + 1))
    assert pwf.packed_move(ups, base, W, 2 * S, 40, 40) == pnw.UP


@pytest.mark.parametrize("R,D,W,C", [(256, 256, 128, 4), (200, 190, 96, 4),
                                     (301, 299, 32, 4), (320, 256, 256, 8),
                                     (300, 512, 512, 16)])
def test_code_windows_match_gather(R, D, W, C):
    """The sliding code windows deliver ``reads_p[clamp(i - 1)]`` and
    ``drafts_p[clamp(j - 1)]`` of the plain DP on every lane with i >= 1
    and j >= 1, for R != D and row widths that are no multiples of four."""
    reads, _rl, drafts, _dl = _rect_batch(R + W, 4, R, D)
    table = pwf.diag_table(R, D, W)
    base, steps = table[: R + D + 1], table[R + D + 1 :]
    read, draft = reads[2], drafts[2]
    read_w = np.pad(read, (0, -R % 4), constant_values=4)
    draft_w = np.pad(draft, (0, -D % 4), constant_values=4)
    reads_p = np.concatenate([read, [4]])
    drafts_p = np.concatenate([draft, [4]])
    checked = 0
    for g in range(32):
        for t, rc, dc in pwf.code_windows(read_w, draft_w, steps, C, g,
                                          R + D):
            j = base[t] + C * g + np.arange(C)
            i = t - j
            on = (i >= 1) & (j >= 1)
            np.testing.assert_array_equal(
                rc[on], reads_p[np.clip(i - 1, 0, R)][on], f"read {g} {t}")
            np.testing.assert_array_equal(
                dc[on], drafts_p[np.clip(j - 1, 0, D)][on], f"draft {g} {t}")
            checked += int(on.sum())
    assert checked > (R + D) * W // 2


@pytest.mark.parametrize("R,D,W", [(128, 128, 128), (512, 512, 128),
                                   (2048, 2048, 256), (301, 299, 32),
                                   (300, 4096, 512), (4096, 300, 512)])
def test_diag_table_holds_bases_then_step_bits(R, D, W):
    T = R + D
    table = pwf.diag_table(R, D, W)
    base = pwf.band_bases(R, D, W)
    assert table.dtype == np.int32 and len(table) == T + 1 + T // 32 + 1
    np.testing.assert_array_equal(table[: T + 1], base)
    words = table[T + 1 :].view(np.uint32)
    t = np.arange(1, T + 1)
    bits = (words[t >> 5] >> (t & 31).astype(np.uint32)) & 1
    np.testing.assert_array_equal(bits, np.diff(base))
    assert int(words[0]) & 1 == 0
    # stepping down from base[T] by the bits gives every base back
    np.testing.assert_array_equal(
        base[T] - np.concatenate([[0], np.cumsum(bits[::-1])]), base[::-1])


@pytest.mark.parametrize("R,D,W", [(256, 256, 128), (300, 256, 128),
                                   (256, 300, 96)])
def test_diag_is_left_or_up_of_the_step_before(R, D, W):
    """diag(t) = s1(t) ? up(t - 1) : left(t - 1) on the plain DP's rows:
    the identity that saves the kernels an exchange of H[t-2]."""
    reads, r_lens, drafts, d_lens = _rect_batch(R + 1, 8, R, D)
    ta = tuple(torch.from_numpy(a) for a in (reads, r_lens, drafts, d_lens))
    rows = []
    pwf._dp_plain(*ta, W, 5, -4, -8, R + D, rows=rows)
    assert len(rows) == R + D
    seen = set()
    for (_t0, _s0, up0, left0, _d0), (t, s1, _up, _left, diag) in zip(
            rows, rows[1:]):
        assert torch.equal(diag, up0 if s1 else left0), t
        seen.add(s1)
    assert seen == {0, 1}


@pytest.mark.parametrize("W,B,want", [
    (128, 64, (4, 1, 1)), (128, 2048, (4, 1, 16)), (96, 600, (4, 1, 8)),
    (256, 1024, (8, 1, 8)), (160, 100, (8, 1, 1)),
    (512, 32, (4, 4, 1)), (512, 511, (4, 4, 1)), (512, 512, (16, 1, 4)),
    (480, 4096, (16, 1, 16)), (320, 16, (4, 4, 1)),
])
def test_wavefront_route_by_width_and_launch_size(W, B, want):
    C, wpr, rpb = pwf._route(W, B, 132)
    assert (C, wpr, rpb) == want
    assert 32 * C * wpr >= W
    assert wpr == 1 or rpb == 1


def test_wavefront_route_covers_every_band_and_refuses_the_rest():
    taken = set()
    for W in range(32, 513, 32):
        for B in (1, 100, 511, 512, 5000):
            C, wpr, rpb = pwf._route(W, B, 132)
            lanes = 32 * C * wpr
            assert lanes >= W and lanes in pwf.ROUTES
            assert (C, wpr) in pwf.ROUTES[lanes]
            assert 1 <= rpb <= pwf.MAX_READS_PER_BLOCK
            taken.add((C, wpr))
    assert taken == {r for routes in pwf.ROUTES.values() for r in routes}
    for W in (0, 16, 100, 544, 1024):
        with pytest.raises(ValueError, match="W in 32..512"):
            pwf._route(W, 64, 132)


@pytest.mark.parametrize("R,D,lanes", [(512, 512, 128), (2048, 2048, 256),
                                       (16384, 16384, 512), (510, 509, 128)])
def test_scratch_is_two_bits_a_cell(R, D, lanes):
    assert pwf._per_read(R, D, lanes) == (R + D + 1) * lanes // 4
    assert 4 * pwf._per_read(R, D, lanes) == (R + D + 1) * lanes
    if (R, D, lanes) == (512, 512, 128):
        assert pwf._per_read(R, D, lanes) == 32800


def test_extension_chunks_alike_under_both_engines(monkeypatch):
    """Under the wavefront engine ``batch_align_segments`` hands
    ``align_mapping_device_raw`` the same chunk sizes it hands
    ``cigar_runs_device_raw`` under the row-scan engine: 40 segments of
    the S = 4096 bucket go out as one launch (the reference's 256 MB of
    direction cells allow 32; two bits a cell allow 64).  Its results
    equal the JAX package's."""
    from haslr_tpu.aligner import extend as ext
    from haslr_tpu_torch.aligner import extend as pext

    from test_torch_aligner import _segments

    class _Recorded(Exception):
        pass

    calls = {"rowscan": [], "wavefront": []}

    def spy(engine):
        def record(reads, r_lens, drafts, d_lens, W, *a, **kw):
            calls[engine].append((reads.shape, W, int(r_lens.sum())))
            raise _Recorded
        return record

    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 3000).astype(np.uint8)
    long_segs = [(t[: 2900 + k], t[k:]) for k in range(40)]
    with monkeypatch.context() as m:
        m.setattr(pext.rsk, "cigar_runs_device_raw", spy("rowscan"))
        m.setattr(pext.nw, "align_mapping_device_raw", spy("wavefront"))
        for engine in ("rowscan", "wavefront"):
            m.setattr(pnw, "ENGINE", engine)
            with pytest.raises(_Recorded):
                pext.batch_align_segments(long_segs, device="cpu")
    assert calls["wavefront"] == calls["rowscan"]
    assert [c[:2] for c in calls["wavefront"]] == [((40, 4096), 512)]

    monkeypatch.setattr(nw, "ENGINE", "wavefront")
    monkeypatch.setattr(pnw, "ENGINE", "wavefront")
    segs = _segments()
    ref = ext.batch_align_segments(segs)
    got = pext.batch_align_segments(segs, device="cpu")
    for i, ((ro, rl, rn), (go, gl, gn)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(ro, go, f"ops {i}")
        np.testing.assert_array_equal(rl, gl, f"lens {i}")
        assert rn == gn, i
