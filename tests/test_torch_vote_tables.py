"""The port's per-window vote tables (``kernels/vote_tables.py``) against
the JAX package's ``consensus_dense._kernel_vote_tables``, exact on all
five tables; the host CSR row offsets the CUDA kernel reads; the tables'
sum over a two-block split; a numpy mirror of the kernel's loop over a
window's row range; and the dense engine's ``PROF``.  Inputs are seeded
numpy planes and stats, handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haslr_tpu.kernels import consensus_dense as cd
from haslr_tpu_torch.kernels import consensus_dense as pcd
from haslr_tpu_torch.kernels import vote_tables as pvt

NAMES = ("counts", "cov_diff", "ins1", "ins2", "n_reads")
CASES = ("code4", "not_ok", "jmax_neg", "empty_windows", "pad_read",
         "one_window")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _round(S, case, seed=0, B=40, N=6):
    """One round's kernel outputs as B1/B4 give them, rows sorted by
    window: planes (B, 3S+256) uint8 of codes 0-4, stats (B, 2) int32
    with jmin <= jmax < S (or jmax = -1 and jmin = 2^29: nothing
    aligned), ok (B,) bool, win (B,) and N.  ``case`` stresses one
    rule."""
    rng = np.random.default_rng(seed)
    if case == "pad_read":  # the dispatch's inert pad read: r_len 0
        B = 1
    planes = rng.integers(0, 5, (B, 3 * S + 256)).astype(np.uint8)
    jmin = rng.integers(0, S, B)
    jmax = np.minimum(S - 1, jmin + rng.integers(0, S, B))
    jmin[: B // 4], jmax[B // 4 : B // 2] = 0, S - 1  # both table edges
    ok = rng.random(B) < 0.9
    win = np.sort(rng.integers(0, N, B))
    if case == "code4":
        planes[rng.random(planes.shape) < 0.7] = 4
    elif case == "not_ok":
        ok = rng.random(B) < 0.5
    elif case == "jmax_neg":
        none = rng.random(B) < 0.4
        jmin[none], jmax[none] = 1 << 29, -1
    elif case == "empty_windows":
        N = 12
        win = np.sort(rng.choice([1, 4, 5, 9], B))
    elif case == "pad_read":
        planes[:] = 4
        jmin[:], jmax[:], ok[:], win[:] = 1 << 29, -1, False, N - 1
    elif case == "one_window":
        win[:] = 2
    stats = np.stack([jmin, jmax], 1).astype(np.int32)
    return planes, stats, ok, win, N


def _torch(planes, stats, ok, win):
    return (torch.from_numpy(planes), torch.from_numpy(stats),
            torch.from_numpy(win).long(), torch.from_numpy(ok))


def _assert_tables(want, got):
    for name, a, b in zip(NAMES, want, got, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("S", (128, 512, 2048))
def test_plain_matches_reference(S, case):
    """``vote_tables_plain`` == the JAX ``_kernel_vote_tables`` (plain
    ``jnp`` on the CPU), and the wrapper takes the plain version for CPU
    tensors."""
    planes, stats, ok, win, N = _round(S, case, seed=S + len(case))
    ref = cd._kernel_vote_tables(
        jnp.asarray(planes), jnp.asarray(stats),
        jnp.asarray(win.astype(np.int32)), jnp.asarray(ok), N, S)
    p, s, w, o = _torch(planes, stats, ok, win)
    got = pvt.vote_tables_plain(p, s, w, o, N, S)
    _assert_tables(ref, [t.numpy() for t in got])
    wp = torch.from_numpy(pvt.window_rows(win, N))
    _assert_tables(got, pvt.vote_tables(p, s, wp, o, N, S))


def _kernel_mirror(planes, stats, ok, win_ptr, N, S):
    """The CUDA kernel's arithmetic in numpy: per window, the rows of its
    CSR range; per plane, 32-bit words of four columns at the plane's
    offset (the last word of an insertion plane reaching past its S+1
    columns); the coverage from the stats on the first insertion plane's
    columns; the last coverage slot 0."""
    off1, off2 = pvt.plane_offsets(S)
    counts = np.zeros((N, S, 4), np.int32)
    ins = np.zeros((2, N, S + 1, 4), np.int32)
    cov = np.zeros(N * (S + 1) + 1, np.int32)
    n_reads = np.zeros(N, np.int32)
    for w in range(N):
        rows = np.arange(win_ptr[w], win_ptr[w + 1])
        rows = rows[ok[rows] & (stats[rows, 1] >= 0)]
        n_reads[w] = len(rows)
        for off, width, out in ((0, S, counts[w]), (off1, S + 1, ins[0, w]),
                                (off2, S + 1, ins[1, w])):
            words = planes[rows, off : off + 4 * (-(-width // 4))]
            for v in range(4):
                out[:, v] = (words == v).sum(0)[:width]
        c = np.arange(S + 1)
        cov[w * (S + 1) : (w + 1) * (S + 1)] = (
            (stats[rows, 0][:, None] == c).sum(0)
            - (stats[rows, 1][:, None] + 1 == c).sum(0))
    return (counts.reshape(N * S, 4), cov, ins[0].reshape(-1, 4),
            ins[1].reshape(-1, 4), n_reads)


@pytest.mark.parametrize("case", CASES)
def test_kernel_mirror_matches_plain(case):
    """The kernel's design (CSR row ranges, four-column words, the
    coverage on the first insertion plane) gives the plain tables."""
    S = 128
    planes, stats, ok, win, N = _round(S, case, seed=7 + len(case))
    want = pvt.vote_tables_plain(*_torch(planes, stats, ok, win), N, S)
    got = _kernel_mirror(planes, stats, ok, pvt.window_rows(win, N), N, S)
    _assert_tables([t.numpy() for t in want], got)


@pytest.mark.parametrize("case", ("random", "empty_windows", "pad_read",
                                  "one_window", "no_rows"))
def test_window_rows_is_searchsorted(case):
    rng = np.random.default_rng(11)
    N = 9
    win = {
        "random": np.sort(rng.integers(0, N, 50)),
        "empty_windows": np.sort(rng.choice([0, 3, 8], 30)),
        "pad_read": np.array([N - 1]),
        "one_window": np.full(20, 4),
        "no_rows": np.zeros(0, np.int64),
    }[case]
    got = pvt.window_rows(win, N)
    assert got.dtype == np.int32 and got.shape == (N + 1,)
    np.testing.assert_array_equal(
        got, np.searchsorted(win, np.arange(N + 1), "left"))


@pytest.mark.parametrize("win", ([0, 2, 1], [0, 3], [-1, 0]))
def test_window_rows_refuses_unsorted_or_out_of_range(win):
    with pytest.raises(ValueError, match="sorted by window"):
        pvt.window_rows(np.array(win), 3)


@pytest.mark.parametrize("cut", ("inside_a_window", "on_a_boundary"))
def test_two_block_split_sums_to_whole(cut):
    """As on a two-shard mesh: each block's tables, from its own CSR
    offsets, summed equal the whole batch's."""
    S = 256
    planes, stats, ok, win, N = _round(S, "not_ok", seed=3, B=48)
    whole = pvt.vote_tables_plain(*_torch(planes, stats, ok, win), N, S)
    ptr = pvt.window_rows(win, N)
    w = int(np.argmax(np.diff(ptr)))  # the window with the most rows
    at = int(ptr[w]) + 1 if cut == "inside_a_window" else int(ptr[w])
    assert 0 < at < len(win) and (win[at - 1] == win[at]) == (
        cut == "inside_a_window")
    parts = []
    for lo, hi in ((0, at), (at, len(win))):
        p, s, _wi, o = _torch(planes[lo:hi], stats[lo:hi], ok[lo:hi],
                              win[lo:hi])
        parts.append(pvt.vote_tables(
            p, s, torch.from_numpy(pvt.window_rows(win[lo:hi], N)), o, N,
            S))
    _assert_tables(whole, [a + b for a, b in zip(*parts)])


def test_wrapper_refuses_other_devices():
    planes, stats, ok, win, N = _round(128, "not_ok")
    p, s, w, o = (t.to("meta") for t in _torch(planes, stats, ok, win))
    with pytest.raises(ValueError, match="unsupported device"):
        pvt.vote_tables(p, s, w, o, N, 128)


@pytest.mark.parametrize("bad", ("short_total", "decreasing", "length"))
def test_wrapper_refuses_bad_row_offsets(bad):
    """On the CPU the wrapper checks the CSR offsets it turns back into
    windows (on the card that would wait for the card)."""
    planes, stats, ok, win, N = _round(128, "not_ok")
    ptr = pvt.window_rows(win, N)
    if bad == "short_total":  # one row fewer than the planes hold
        ptr[-1] -= 1
    elif bad == "decreasing":
        ptr[1] = ptr[2] + 1
    else:
        ptr = ptr[:-1]
    p, s, _w, o = _torch(planes, stats, ok, win)
    with pytest.raises(ValueError, match="CSR row offsets"):
        pvt.vote_tables(p, s, torch.from_numpy(ptr), o, N, 128)


def test_dense_consensus_prof():
    """The dense engine's host phases, keyed as the reference keys them,
    after a CPU call; ``PROF.clear()`` resets them."""
    rng = np.random.default_rng(5)
    windows = []
    for L in (280, 300, 320):
        true = rng.integers(0, 4, L).astype(np.uint8)
        windows.append([true.copy() for _ in range(5)])
    pcd.PROF.clear()
    pcd.dense_consensus(windows, device="cpu")
    keys = set(pcd.PROF)
    assert keys == {"pack", "n_dispatch", "dispatch_S512_B15",
                    "device_S512_B15", "unpack"}, keys
    assert pcd.PROF["n_dispatch"] == 1
    assert all(v >= 0 for v in pcd.PROF.values())
    pcd.PROF.clear()
    assert pcd.PROF == {}
