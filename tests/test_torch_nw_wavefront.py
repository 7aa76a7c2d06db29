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
from haslr_tpu_torch.kernels import consensus_dense as pcd
from haslr_tpu_torch.kernels import nw as pnw
from haslr_tpu_torch.kernels import nw_rowscan as prs
from haslr_tpu_torch.kernels import nw_wavefront as pwf

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
    """Port: wavefront vote planes reduced with index_add_.  Reference:
    XLA wavefront mapping + ``consensus_dense._scatter_votes``."""
    S = 2 * W
    reads, r_lens, dr_r, dl_r, win_idx, N = _window_batch(W + 5, 32, S, W)
    ok = _in_gate(r_lens, dl_r, W)
    ja = tuple(jnp.asarray(a) for a in (reads, r_lens, dr_r, dl_r))
    mapping = nw._align_mapping(*ja, S, S, W, 5, -4, -8, False, "wavefront")
    ref = cd._scatter_votes(mapping, ja[0], ja[1], jnp.asarray(win_idx),
                            jnp.asarray(ok), N, S)
    ta = tuple(torch.from_numpy(a) for a in (reads, r_lens, dr_r, dl_r))
    planes, stats = pwf.wavefront_votes(*ta, W, 5, -4, -8)
    got = pcd._vote_tables(planes, stats, torch.from_numpy(win_idx).long(),
                           torch.from_numpy(ok), N, S)
    for name, a, b in zip(("counts", "cov_diff", "ins1", "ins2", "n_reads"),
                          ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)


@pytest.mark.parametrize("engine", ["rowscan", "wavefront"], indirect=True)
def test_align_mapping_device_matches_reference(engine):
    """``align_mapping_device`` under either engine: the same mapping and
    dtype as the JAX function under the same engine (row-scan: B3's
    plain version; wavefront: B5's)."""
    _ja, _ta, arrays = _batch(17, 16, 256, 128)
    ref = nw.align_mapping_device(*arrays, 128, 2, -4, -2)
    got = pnw.align_mapping_device(*arrays, 128, 2, -4, -2, device="cpu")
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
