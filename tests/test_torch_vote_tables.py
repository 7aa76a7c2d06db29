"""The port's per-window vote tables (``kernels/vote_tables.py``) against
the JAX package's ``consensus_dense._kernel_vote_tables``, exact on all
five tables; the host CSR row offsets the CUDA kernel reads; the tables'
sum over a two-block split; a numpy mirror of the kernel's decomposition
(persistent work items of (window, column tile), chunks of rows, packed
8-bit counts widened after each chunk) at whole-window and column-tiled
widths, deep and empty windows; the wrapper's refusals; and the dense
engine's ``PROF``.  Inputs are seeded numpy planes and stats, handed to
both packages."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from haslr_tpu.kernels import consensus_dense as cd
from haslr_tpu_torch.kernels import consensus_dense as pcd
from haslr_tpu_torch.kernels import vote_tables as pvt

NAMES = ("counts", "cov_diff", "ins1", "ins2", "n_reads")
# the kernel's widest column tile and rows a ring stage
# (``csrc/vote_tables.cu`` kMaxTile, kChunk), which the mirror follows
MAX_TILE, CHUNK = 512, 16
KERNEL_SRC = os.path.join(os.path.dirname(pvt.__file__), os.pardir,
                          "csrc", "vote_tables.cu")
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


def _tally(words, use):
    """The kernel's byte-parallel count of one chunk: ``words`` (rows, n)
    uint32 of four plane bytes, ``use`` (rows,) the voting rows.  Returns
    (4, n) uint32, byte k of row v counting byte k equal to v.  A byte
    votes when its top six bits are 0."""
    high = words & np.uint32(0xFCFCFCFC)
    nonzero = ((high & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) \
        | high
    votes = (~nonzero >> np.uint32(7)) \
        & np.where(use, np.uint32(0x01010101), np.uint32(0))[:, None]
    b0 = words & np.uint32(0x01010101)
    b1 = (words >> np.uint32(1)) & np.uint32(0x01010101)
    return np.stack([(votes & ~(b0 | b1)).sum(0, dtype=np.uint32),
                     (votes & b0 & ~b1).sum(0, dtype=np.uint32),
                     (votes & ~b0 & b1).sum(0, dtype=np.uint32),
                     (votes & b0 & b1).sum(0, dtype=np.uint32)])


def _kernel_mirror(planes, stats, ok, win_ptr, N, S, grid=3, chunk=CHUNK):
    """The CUDA kernel's decomposition in numpy: work items (window,
    column tile of min(S, MAX_TILE) columns) taken by ``grid`` persistent
    CTAs in strides; each item's rows in chunks of ``chunk`` as the ring's
    stages hold them (the plane segments of the bulk copies, an
    insertion plane's TC + 16 bytes); per chunk the packed 8-bit counts
    of four-column words (:func:`_tally`), widened into the item's int32
    rows; the coverage of the tile's columns from the rows' (jmin, jmax),
    (-1, -2) for a row that does not vote; the item's slices written to
    the outputs, poisoned first so that a slot no item writes shows."""
    tc = min(S, MAX_TILE)
    ntiles = S // tc
    off1, off2 = pvt.plane_offsets(S)
    counts = np.full((N * S, 4), -7, np.int32)
    ins1 = np.full((N * (S + 1), 4), -7, np.int32)
    ins2 = np.full((N * (S + 1), 4), -7, np.int32)
    cov = np.full(N * (S + 1) + 1, -7, np.int32)
    n_reads = np.full(N, -7, np.int32)
    for cta in range(grid):
        for item in range(cta, N * ntiles, grid):
            w, t = divmod(item, ntiles)
            cb, last = t * tc, int(t == ntiles - 1)
            lo, hi = int(win_ptr[w]), int(win_ptr[w + 1])
            tab = np.zeros((3 * tc + 2, 4), np.int32)
            cs = np.zeros(tc + 1, np.int32)
            voting = 0
            for c in range(max(1, -(-(hi - lo) // chunk))):
                rows = np.arange(lo + c * chunk, min(lo + (c + 1) * chunk,
                                                     hi))
                stage = np.concatenate(
                    [planes[rows, cb : cb + tc],
                     planes[rows, off1 + cb : off1 + cb + tc + 16],
                     planes[rows, off2 + cb : off2 + cb + tc + 16]], 1)
                use = ok[rows] & (stats[rows, 1] >= 0)
                meta = np.where(use[:, None], stats[rows], [-1, -2])
                voting += int(use.sum())
                for j, d in ((meta[:, 0] - cb, 1), (meta[:, 1] + 1 - cb, -1)):
                    np.add.at(cs, j[(j >= 0) & (j < tc + last)], d)
                # (stage offset, table row, columns) of each plane; the
                # word past an insertion plane's TC columns holds column S
                for soff, at, width in ((0, 0, tc), (tc, tc, tc + last),
                                        (2 * tc + 16, 2 * tc + 1,
                                         tc + last)):
                    words = np.ascontiguousarray(
                        stage[:, soff : soff + 4 * -(-width // 4)]
                    ).view("<u4")
                    packed = _tally(words, use)
                    for k in range(4):
                        cols = tab[at + k : at + width : 4]
                        cols += ((packed >> np.uint32(8 * k))
                                 & np.uint32(0xFF)).T[: len(cols)].astype(
                                     np.int32)
            counts[w * S + cb : w * S + cb + tc] = tab[:tc]
            at = w * (S + 1) + cb
            ins1[at : at + tc + last] = tab[tc : 2 * tc + last]
            ins2[at : at + tc + last] = tab[2 * tc + 1 : 3 * tc + 1 + last]
            cov[at : at + tc + last] = cs[: tc + last]
            if t == 0:
                n_reads[w] = voting
    cov[N * (S + 1)] = 0
    return counts, cov, ins1, ins2, n_reads


def _reference(planes, stats, ok, win, N, S):
    return cd._kernel_vote_tables(
        jnp.asarray(planes), jnp.asarray(stats),
        jnp.asarray(win.astype(np.int32)), jnp.asarray(ok), N, S)


@pytest.mark.parametrize("S", (128, 512, 1024))
@pytest.mark.parametrize("case", CASES)
def test_kernel_mirror_matches_plain(case, S):
    """The kernel's design (persistent items of (window, column tile),
    chunks of rows, packed 8-bit counts widened after each chunk, the
    coverage by tile) gives the plain tables and the JAX package's; S =
    1024 is column-tiled (two tiles a window)."""
    planes, stats, ok, win, N = _round(S, case, seed=7 + len(case))
    want = pvt.vote_tables_plain(*_torch(planes, stats, ok, win), N, S)
    got = _kernel_mirror(planes, stats, ok, pvt.window_rows(win, N), N, S)
    _assert_tables([t.numpy() for t in want], got)
    _assert_tables(_reference(planes, stats, ok, win, N, S), got)


@pytest.mark.parametrize("grid", (3, 7))
@pytest.mark.parametrize("S", (128, 512, 1024))
def test_kernel_mirror_deep_and_empty_windows(S, grid):
    """Windows deeper than the 8-bit counters (255 rows) and than the
    ring, among empty ones and ones cut at the chunks' edges (1, 16, 17,
    32, 33 rows), N no multiple of the grid: the mirror equals the plain
    tables and the JAX package's."""
    sizes = [0, 300, 0, 1, 16, 17, 0, 32, 33, 0, 0, 257, 0]
    assert len(sizes) % grid
    planes, stats, ok, _win, _N = _round(S, "not_ok", seed=S + grid,
                                         B=sum(sizes))
    N = len(sizes)
    win = np.repeat(np.arange(N), sizes)
    want = pvt.vote_tables_plain(*_torch(planes, stats, ok, win), N, S)
    got = _kernel_mirror(planes, stats, ok, pvt.window_rows(win, N), N, S,
                         grid=grid)
    _assert_tables([t.numpy() for t in want], got)
    _assert_tables(_reference(planes, stats, ok, win, N, S), got)


@pytest.mark.parametrize("chunk", (1, 32))
def test_kernel_mirror_chunk_limits(chunk):
    """A stage of one row and one of 32 (one a producer lane; the 8-bit
    counters hold 32 rows' votes) give the same tables."""
    S = 512
    planes, stats, ok, win, N = _round(S, "one_window", seed=chunk, B=70)
    want = pvt.vote_tables_plain(*_torch(planes, stats, ok, win), N, S)
    got = _kernel_mirror(planes, stats, ok, pvt.window_rows(win, N), N, S,
                         chunk=chunk)
    _assert_tables([t.numpy() for t in want], got)


def test_tally_counts_only_codes_0_to_3():
    """Every byte value 0-255 at every byte of a word whose other bytes
    are code 4: the packed count of code v is 1 exactly where the byte
    is v < 4, and nothing for a row that does not vote."""
    vals = np.arange(256, dtype=np.uint32)
    for k in range(4):
        rest = np.uint32(0x04040404 & ~(0xFF << (8 * k)))
        words = ((vals << np.uint32(8 * k)) | rest)[:, None]
        for use in (True, False):
            got = np.stack([_tally(words[i : i + 1], np.array([use]))[:, 0]
                            for i in range(256)])
            want = np.zeros((256, 4), np.uint32)
            if use:
                want[np.arange(4), np.arange(4)] = 1 << (8 * k)
            np.testing.assert_array_equal(got, want)


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


@pytest.mark.parametrize("name,value", (("kMaxTile", MAX_TILE),
                                        ("kChunk", CHUNK)))
def test_mirror_follows_kernel_constants(name, value):
    """The mirror's tile and chunk are the kernel source's."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    got = re.search(rf"constexpr int {name} = (\d+);", src)
    assert got and int(got.group(1)) == value


@pytest.mark.parametrize("S", (0, -512, 100, 520, 1040))
def test_cuda_args_refuse_widths(S):
    """The kernel takes S a multiple of 16 (the bulk copies' sizes and
    offsets), and above one tile (512 columns) a multiple of it."""
    B, N = 4, 2
    planes = torch.zeros((B, 3 * max(S, 0) + 256), dtype=torch.uint8)
    stats = torch.zeros((B, 2), dtype=torch.int32)
    ok = torch.ones(B, dtype=torch.bool)
    win_ptr = torch.tensor([0, 2, B], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        pvt._check_cuda_args(planes, stats, win_ptr, ok, N, S)


@pytest.mark.parametrize("bad", ("none", "S_not_16", "row_stride",
                                 "storage_offset"))
def test_cuda_args_refuse_unaligned_planes(bad):
    """The kernel's argument checks (run for CUDA tensors; here on CPU
    tensors of the same shapes): the bulk copies need the planes' row
    stride and storage 16-byte aligned."""
    S, B, N = 128, 8, 3
    W = 3 * S + 256
    if bad == "S_not_16":
        S = 100
        W = 3 * S + 256
    planes = torch.zeros((B, W), dtype=torch.uint8)
    if bad == "row_stride":
        planes = torch.zeros((B, W + 4), dtype=torch.uint8)[:, :W]
    elif bad == "storage_offset":
        planes = torch.zeros(B * W + 4, dtype=torch.uint8)[4:].view(B, W)
    stats = torch.zeros((B, 2), dtype=torch.int32)
    ok = torch.ones(B, dtype=torch.bool)
    win_ptr = torch.from_numpy(pvt.window_rows(np.arange(B) * N // B, N))
    if bad == "none":
        pvt._check_cuda_args(planes, stats, win_ptr, ok, N, S)
        return
    match = "multiple of 16" if bad == "S_not_16" else "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        pvt._check_cuda_args(planes, stats, win_ptr, ok, N, S)


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
