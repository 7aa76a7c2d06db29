"""Anti-diagonal (wavefront) banded NW: plain PyTorch versions and the CUDA
kernel wrappers.

Port of the wavefront engine of :mod:`haslr_tpu.kernels.nw` (the XLA
``_nw_scan_inner`` and the wavefront branch of ``_align_mapping_inner``)
and of its Pallas kernels in :mod:`haslr_tpu.kernels.nw_pallas`.  The DP
advances over ``T = R + D`` anti-diagonals on a W-lane band that follows
the main diagonal (:func:`band_bases`); the lanes of one diagonal are
independent.  Three products, each a plain version here and a CUDA kernel
in ``csrc/wavefront.cu``:

- the (T+1, B, W) direction tensor (:func:`wavefront_dirs`, for the host
  traceback ``nw.traceback_batch``) — ``hx_wavefront_dirs``;
- DP + traceback -> (B, R) read->draft mapping (:func:`wavefront_mapping`,
  ``nw.align_mapping_device`` and the extension under
  ``nw.ENGINE = "wavefront"``) — ``hx_wavefront_mapping``;
- DP + traceback -> vote planes and the aligned span
  (:func:`wavefront_votes`, the consensus rounds under the same engine;
  the layout of :func:`~haslr_tpu_torch.kernels.nw_rowscan.rowscan_votes`)
  — ``hx_wavefront_votes``.

The traceback walks one move at a time from (r_len, d_len), as
``traceback_batch`` does.  Each wrapper takes its plain version for CPU
tensors and launches its kernel for CUDA tensors (or raises); there is no
fallback between the two.  Inputs follow the reference's contract:
``r_lens <= R`` and ``d_lens <= D``.

The kernels run a thread on C band lanes and a read on WPR warps
(32 * C * WPR lanes: 128, 256 or 512; the row-scan kernels' routes,
``nw_rowscan._route`` picks by band width and launch size); a band of
another width (32 to
512 in steps of 32) runs on the next of these with its spare lanes
masked, and code rows are padded to a multiple of four
(``nw_rowscan._word_rows``).  The mapping and votes kernels keep two bits
a direction in a global scratch of :func:`_per_read` bytes a read.  What
the kernels do with bits has numpy mirrors here that the CPU tests hold
to the plain versions: the band's step bits (:func:`diag_table`), the
sliding code windows (:func:`code_windows`), and the packed diagonal with
its walk (:func:`pack_dirs_diag`, :func:`packed_move`,
:func:`mapping_from_packed`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from haslr_tpu_torch import trace
from haslr_tpu_torch.kernels.nw_rowscan import (
    DIAG,
    LEFT,
    MAX_READS_PER_BLOCK,
    NEG,
    ROUTES,
    UP,
    _route,
    _sm_count,
    _word_rows,
    check_indexed,
    chunked_plain,
    launch_chunked,
    pack_dirs_row,
    takes_plain,
)

# kernel launches by wrapper (plain-version calls do not count)
LAUNCHES = {"wavefront_dirs": 0, "wavefront_mapping": 0,
            "wavefront_votes": 0}


def band_bases(R: int, D: int, W: int) -> np.ndarray:
    """Lane-0 draft column per anti-diagonal t in [0, R+D], centred on
    the main diagonal, monotone (numpy copy of
    ``haslr_tpu.kernels.nw.band_bases``)."""
    t = np.arange(R + D + 1, dtype=np.int64)
    center = (t * D) // (R + D)
    hi = max(0, D - W + 1)
    base = np.clip(center - W // 2, 0, hi)
    base = np.maximum.accumulate(base)
    return base.astype(np.int32)


def _checked_bases(R: int, D: int, W: int) -> np.ndarray:
    """:func:`band_bases`, refused unless it advances by 0 or 1 column per
    diagonal: the DP reads its neighbours at lane shifts of -1..1 only."""
    base = band_bases(R, D, W)
    step = np.diff(base)
    if ((step < 0) | (step > 1)).any():
        raise ValueError(
            f"wavefront band unsupported for R={R}, D={D}, W={W}: the band "
            "bases must advance by 0 or 1 column per anti-diagonal"
        )
    return base


# --------------------------------------------------------------------------
# plain PyTorch versions (vectorised over the batch, a Python loop over
# diagonals / traceback moves); the CPU path and the kernels' reference
# --------------------------------------------------------------------------


def _dp_plain(reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
              t_hi, rows=None):
    """Diagonals 0..t_hi of the DP; directions (t_hi+1, B, W) uint8.  A
    list given as ``rows`` takes ``(t, s1, up, left, diag)`` of every
    diagonal, the neighbour scores as the step read them."""
    B, R = reads.shape
    D = drafts.shape[1]
    dev = reads.device
    base = _checked_bases(R, D, W)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    rl = r_lens.to(torch.int32)[:, None]
    dl = d_lens.to(torch.int32)[:, None]
    neg, match_t, mismatch_t = torch.tensor(
        [NEG, match, mismatch], dtype=torch.int32, device=dev
    )
    pad = torch.full((B, 1), 4, dtype=torch.uint8, device=dev)
    reads_p = torch.cat([reads, pad.to(reads.dtype)], 1)
    drafts_p = torch.cat([drafts, pad.to(drafts.dtype)], 1)
    negcol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    h2 = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    h1 = h2.clone()
    h1[:, 0] = 0  # t = 0: cell (0, 0) at lane 0
    dirs = torch.zeros((t_hi + 1, B, W), dtype=torch.uint8, device=dev)
    for t in range(1, t_hi + 1):
        b = int(base[t])
        s1 = b - int(base[t - 1])
        h1p = torch.cat([negcol, h1, negcol], 1)  # lanes -1 .. W
        up = h1p[:, s1 + 1 : s1 + 1 + W]
        left = h1p[:, s1 : s1 + W]
        if t >= 2:  # at t = 1 diagonal t-2 is all NEG
            s2 = b - int(base[t - 2])
            h2p = torch.cat([negcol, h2, negcol, negcol], 1)  # -1 .. W+1
            diag = h2p[:, s2 : s2 + W]
        else:
            diag = h2
        if rows is not None:
            rows.append((t, s1, up, left, diag))
        j = b + lanes
        i = t - j
        rb = reads_p[:, torch.clamp(i - 1, 0, R).long()]
        db = drafts_p[:, torch.clamp(j - 1, 0, D).long()]
        sub = torch.where(rb == db, match_t, mismatch_t)
        cand_d = torch.where((i >= 1) & (j >= 1), diag + sub, neg)
        cand_u = torch.where(i >= 1, up + gap, neg)
        cand_l = torch.where(j >= 1, left + gap, neg)
        h = torch.maximum(cand_d, torch.maximum(cand_u, cand_l))
        dirs[t] = torch.where(
            h == cand_d, DIAG, torch.where(h == cand_u, UP, LEFT)
        ).to(torch.uint8)
        valid = (i >= 0) & (i <= rl) & (j >= 0) & (j <= dl)
        h2, h1 = h1, torch.where(valid, h, neg)
    return dirs


def wavefront_dirs_plain(reads, r_lens, drafts, d_lens, W, match,
                         mismatch, gap):
    """The DP over every diagonal: directions (T+1, B, W) uint8, row 0
    zero (the XLA ``_nw_scan_inner``'s output, every cell)."""
    T = reads.shape[1] + drafts.shape[1]
    return _dp_plain(reads, r_lens, drafts, d_lens, W, match, mismatch,
                     gap, T)


def _walk(reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
          on_move):
    """DP up to the batch's last needed diagonal, then a move-lockstep
    traceback from (r_len, d_len): every read takes one move per
    iteration, as ``traceback_batch`` does.  Calls ``on_move(i, j,
    active, is_diag, is_up)`` before each move."""
    B, R = reads.shape
    D = drafts.shape[1]
    dev = reads.device
    i = r_lens.to(torch.int64).clone()
    j = d_lens.to(torch.int64).clone()
    n_moves = int((i + j).max().clamp(0, R + D)) if B else 0
    dirs = _dp_plain(reads, r_lens, drafts, d_lens, W, match, mismatch,
                     gap, n_moves)
    base = torch.from_numpy(band_bases(R, D, W)).to(dev).long()
    bidx = torch.arange(B, device=dev)
    for _ in range(n_moves):
        active = (i > 0) | (j > 0)
        t = (i + j).clamp(0, n_moves)
        lane = j - base[t]
        in_band = (lane >= 0) & (lane < W)
        d = torch.where(in_band, dirs[t, bidx, lane.clamp(0, W - 1)].long(),
                        LEFT)
        d = torch.where(i == 0, LEFT, d)
        d = torch.where(j == 0, UP, d)
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        on_move(i, j, active, is_diag, is_up)
        i = i - (is_diag | is_up).long()
        j = j - (active & ~is_up).long()


def wavefront_mapping_plain(reads, r_lens, drafts, d_lens, W, match,
                            mismatch, gap):
    """(B, R) int32 read->draft mapping: j for a base aligned to draft
    column j, -(a+3) for a base inserted after column a, -1 unused."""
    B, R = reads.shape
    mapping = torch.full((B, R + 1), -1, dtype=torch.int32,
                         device=reads.device)
    bidx = torch.arange(B, device=reads.device)

    def on_move(i, j, active, is_diag, is_up):
        val = torch.where(is_diag, j - 1, -(j + 2)).to(torch.int32)
        mapping[bidx, torch.where(is_diag | is_up, i - 1, R)] = val

    _walk(reads, r_lens, drafts, d_lens, W, match, mismatch, gap, on_move)
    return mapping[:, :R]


def wavefront_votes_plain(reads, r_lens, drafts, d_lens, W, match,
                          mismatch, gap):
    """Plain version of the vote-plane kernel: ``planes`` (B, 3D + 256)
    uint8 and ``stats`` (B, 2) int32 (layout in ``csrc/wavefront.cu``).
    Insertion runs follow ``nw_pallas._votes_kernel``: consecutive UP
    moves at one anchor; any other move ends the run (LEFT too)."""
    B, R = reads.shape
    D = drafts.shape[1]
    DQ = D + 128
    dev = reads.device
    bidx = torch.arange(B, device=dev)
    reads_p = torch.cat(
        [reads, torch.full((B, 1), 4, dtype=reads.dtype, device=dev)], 1
    ).to(torch.int64) & 3
    # one dump column past each plane takes the writes that drop
    pb = torch.full((B, D + 1), 4, dtype=torch.uint8, device=dev)
    pa = torch.full((B, DQ + 1), 4, dtype=torch.uint8, device=dev)
    pa2 = torch.full((B, DQ + 1), 4, dtype=torch.uint8, device=dev)
    st = {
        "anchor": torch.full((B,), -9, dtype=torch.int64, device=dev),
        "b_a": torch.full((B,), 4, dtype=torch.int64, device=dev),
        "b_b": torch.full((B,), 4, dtype=torch.int64, device=dev),
        "jmn": torch.full((B,), 1 << 29, dtype=torch.int64, device=dev),
        "jmx": torch.full((B,), -1, dtype=torch.int64, device=dev),
    }

    def flush(cond):
        q = st["anchor"] + 1
        at = torch.where(cond & (q >= 0) & (q < DQ), q, DQ)
        pa[bidx, at] = st["b_a"].to(torch.uint8)
        pa2[bidx, at] = st["b_b"].to(torch.uint8)

    def on_move(i, j, active, is_diag, is_up):
        rb = reads_p[bidx, (i - 1).clamp(0, R)]
        c = j - 1
        pb[bidx, torch.where(is_diag & (c >= 0) & (c < D), c, D)] = \
            rb.to(torch.uint8)
        st["jmn"] = torch.where(is_diag, torch.minimum(st["jmn"], c),
                                st["jmn"])
        st["jmx"] = torch.where(is_diag, torch.maximum(st["jmx"], c),
                                st["jmx"])
        anchor = st["anchor"]
        same_run = is_up & (anchor == c)
        ended = active & (anchor >= -1) & ~same_run
        flush(ended)
        b_a, b_b = st["b_a"], st["b_b"]
        st["b_b"] = torch.where(same_run, b_a, torch.where(is_up, 4, b_b))
        st["b_a"] = torch.where(is_up, rb, torch.where(ended, 4, b_a))
        st["anchor"] = torch.where(is_up, c,
                                   torch.where(ended, -9, anchor))

    _walk(reads, r_lens, drafts, d_lens, W, match, mismatch, gap, on_move)
    flush(st["anchor"] >= -1)
    planes = torch.cat([pb[:, :D], pa[:, :DQ], pa2[:, :DQ]], 1)
    stats = torch.stack([st["jmn"], st["jmx"]], 1).to(torch.int32)
    return planes, stats


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def diag_table(R: int, D: int, W: int) -> np.ndarray:
    """What the kernels read of the band, one int32 array:
    :func:`band_bases` (T + 1 entries, T = R + D), then T // 32 + 1 words
    of step bits, bit ``t & 31`` of word ``t >> 5`` set where the band
    advances a column between diagonals ``t - 1`` and ``t``."""
    base = band_bases(R, D, W)
    T = R + D
    bits = np.zeros((T // 32 + 1) * 32, np.uint32)
    bits[1 : T + 1] = np.diff(base)
    words = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint32)).sum(
        1, dtype=np.uint32)
    return np.concatenate([base, words.view(np.int32)])


@functools.lru_cache(maxsize=None)
def _base_tensor(R, D, W, device):
    return torch.from_numpy(diag_table(R, D, W)).to(check_indexed(device))


def _front(reads, r_lens, drafts, d_lens, W) -> bool:
    """The band check, then True for CPU tensors (plain version)."""
    _checked_bases(reads.shape[1], drafts.shape[1], W)
    return takes_plain(reads, r_lens, drafts, d_lens, W)


def _plain_bytes(reads, drafts, W) -> int:
    """Bytes of one read's directions in the plain versions, a byte a
    cell."""
    return (reads.shape[1] + drafts.shape[1] + 1) * W


def _per_read(R: int, D: int, lanes: int) -> int:
    """Bytes of one read's packed direction scratch in the kernels:
    R + D + 1 diagonals of ``lanes`` cells, two bits a cell."""
    return (R + D + 1) * (lanes // 4)


def _launch(name, reads, r_lens, drafts, d_lens, W, outs, scores):
    """Launch ``hx_{name}`` (mapping or votes) over the batch."""
    B, R = reads.shape
    D = drafts.shape[1]
    C, wpr, rpb = _route(W, B, _sm_count(reads.device))
    reads, r_lens, drafts = _word_rows(reads, r_lens, drafts)
    launch_chunked(name, LAUNCHES, reads, r_lens, drafts, d_lens, W,
                   _base_tensor(R, D, W, reads.device),
                   _per_read(R, D, 32 * C * wpr), outs,
                   (*scores, R, D, C, wpr, rpb))


# numpy mirrors of what the kernels do with bits

def pack_dirs_diag(row: np.ndarray) -> np.ndarray:
    """One direction diagonal (lanes,) of values 0..2 as the mapping and
    votes kernels store it: two bits a lane, 16 lanes a uint32 word
    (:func:`~haslr_tpu_torch.kernels.nw_rowscan.pack_dirs_row`), each the
    winning candidate's tag ``2 - direction`` (DIAG 2, UP 1, LEFT 0), the
    low bits of the kernels' tagged score maximum."""
    return pack_dirs_row(2 - np.asarray(row, np.int64))


def packed_move(words, base, W, t_hi, i, j) -> int:
    """The kernels' traceback move from ``(i, j) != (0, 0)`` on packed
    diagonals ``words`` (t, lanes // 16) uint32 (:func:`pack_dirs_diag`
    rows): 2 minus the cell's two bits, LEFT when it lies out of the band
    or past diagonal ``t_hi``, then LEFT at i == 0, then UP at j == 0."""
    t = i + j
    d = LEFT
    if t <= t_hi:
        lane = j - int(base[t])
        if 0 <= lane < W:
            d = 2 - ((int(words[t, lane >> 4]) >> (2 * (lane & 15))) & 3)
    if i == 0:
        d = LEFT
    if j == 0:
        d = UP
    return d


def mapping_from_packed(words, base, W, r_len, d_len, R) -> np.ndarray:
    """One read's (R,) int32 mapping by :func:`packed_move` from
    ``(r_len, d_len)``, as the mapping kernel's walk writes it."""
    out = np.full(R, -1, np.int32)
    i, j = int(r_len), int(d_len)
    t_hi = min(max(i + j, 0), len(words) - 1)
    while (i > 0 or j > 0) and i <= R:
        d = packed_move(words, base, W, t_hi, i, j)
        if d == DIAG:
            out[i - 1] = j - 1
        elif d == UP:
            out[i - 1] = -(j + 2)
        i -= d != LEFT
        j -= d != UP
    return out


def code_windows(read, draft, steps, C, g, t_hi):
    """The sliding code windows of the thread that owns lanes ``C g ..
    C g + C - 1``, as the kernels keep them: yields ``(t, read codes (C,),
    draft codes (C,))`` for t = 1 .. t_hi.  ``read`` and ``draft`` are code
    rows a multiple of four wide, ``steps`` the step-bit words of the
    band's :func:`diag_table`.  Four bits a lane in one integer each; on
    a diagonal where the band stays the read codes move
    one lane up and lane 0 takes in the next code of the read, where it
    advances the draft codes move one lane down and lane C - 1 takes in
    the next code of the draft; codes come four a word, indices outside
    the row read the pad code 4."""
    rwords = np.ascontiguousarray(read, np.uint8).view(np.uint32)
    dwords = np.ascontiguousarray(draft, np.uint8).view(np.uint32)
    steps = np.asarray(steps).view(np.uint32)

    def word(words, wi):
        return int(words[wi]) if 0 <= wi < len(words) else 0x04040404

    k0 = C * g
    mask = (1 << (4 * C)) - 1
    rpk = 0x4444444444444444 & mask
    dpk = 0
    for c in range(C):
        jj = k0 + c - 1
        dpk |= ((word(dwords, jj >> 2) >> (8 * (jj & 3))) & 15) << (4 * c)
    nr, nd = -k0, k0 + C - 1
    for t in range(1, t_hi + 1):
        if (int(steps[t >> 5]) >> (t & 31)) & 1:
            code = (word(dwords, nd >> 2) >> (8 * (nd & 3))) & 15
            dpk = (dpk >> 4) | (code << (4 * (C - 1)))
            nd += 1
        else:
            code = (word(rwords, nr >> 2) >> (8 * (nr & 3))) & 15
            rpk = ((rpk << 4) | code) & mask
            nr += 1
        yield (t, np.array([(rpk >> (4 * c)) & 15 for c in range(C)]),
               np.array([(dpk >> (4 * c)) & 15 for c in range(C)]))


def wavefront_dirs(reads, r_lens, drafts, d_lens, W, match, mismatch, gap):
    """The wavefront DP's direction tensor (T+1, B, W) uint8 on the
    tensors' device (row 0 zero).

    CPU tensors: :func:`wavefront_dirs_plain`.  CUDA tensors (uint8
    codes, int32 lengths, contiguous): the ``hx_wavefront_dirs`` kernel,
    by :func:`_route`.
    The output is the whole tensor, so the batch is not chunked."""
    if _front(reads, r_lens, drafts, d_lens, W):
        return wavefront_dirs_plain(reads, r_lens, drafts, d_lens, W,
                                    match, mismatch, gap)
    from haslr_tpu_torch.kernels import _build

    B, R = reads.shape
    D = drafts.shape[1]
    C, wpr, rpb = _route(W, B, _sm_count(reads.device))
    dirs = torch.empty((R + D + 1, B, W), dtype=torch.uint8,
                       device=reads.device)
    reads, r_lens, drafts = _word_rows(reads, r_lens, drafts)
    fn = _build.lib()["hx_wavefront_dirs"]
    stream = torch.cuda.current_stream(reads.device)
    # the tensors' card current
    with torch.cuda.device(reads.device), trace.launch(
            "wavefront_dirs", B, reads.shape[1], W, r_lens, stream=stream):
        err = fn(
            reads.data_ptr(), r_lens.data_ptr(), drafts.data_ptr(),
            d_lens.data_ptr(),
            _base_tensor(R, D, W, reads.device).data_ptr(), dirs.data_ptr(),
            B, reads.shape[1], drafts.shape[1], W, match, mismatch, gap, R,
            D, C, wpr, rpb, stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wavefront_dirs kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["wavefront_dirs"] += 1
    return dirs


def wavefront_mapping(reads, r_lens, drafts, d_lens, W, match, mismatch,
                      gap):
    """Wavefront DP + traceback: (B, R) int32 read->draft mapping
    (encoding of :func:`wavefront_mapping_plain`).

    CPU tensors: :func:`wavefront_mapping_plain`.  CUDA tensors: the
    ``hx_wavefront_mapping`` kernel."""
    if _front(reads, r_lens, drafts, d_lens, W):
        (mapping,) = chunked_plain(
            reads, r_lens, drafts, d_lens, W,
            lambda *a: (wavefront_mapping_plain(*a),),
            (match, mismatch, gap), _plain_bytes(reads, drafts, W),
        )
        return mapping
    B, R = reads.shape
    mapping = torch.full((B, R), -1, dtype=torch.int32, device=reads.device)
    _launch("wavefront_mapping", reads, r_lens, drafts, d_lens, W,
            ((mapping, 4 * R),), (match, mismatch, gap))
    return mapping


def wavefront_votes(reads, r_lens, drafts, d_lens, W, match, mismatch,
                    gap):
    """Wavefront DP + vote-plane traceback: ``planes`` (B, 3D + 256) uint8
    and ``stats`` (B, 2) int32, as :func:`~haslr_tpu_torch.kernels.
    nw_rowscan.rowscan_votes` gives them.

    CPU tensors: :func:`wavefront_votes_plain`.  CUDA tensors: the
    ``hx_wavefront_votes`` kernel."""
    if _front(reads, r_lens, drafts, d_lens, W):
        return chunked_plain(reads, r_lens, drafts, d_lens, W,
                             wavefront_votes_plain, (match, mismatch, gap),
                             _plain_bytes(reads, drafts, W))
    B = reads.shape[0]
    D = drafts.shape[1]
    planes = torch.full((B, 3 * D + 256), 4, dtype=torch.uint8,
                        device=reads.device)
    stats = torch.empty((B, 2), dtype=torch.int32, device=reads.device)
    _launch("wavefront_votes", reads, r_lens, drafts, d_lens, W,
            ((planes, 3 * D + 256), (stats, 8)), (match, mismatch, gap))
    return planes, stats
