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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from haslr_tpu_torch.kernels.nw_rowscan import (
    DIAG,
    LEFT,
    NEG,
    UP,
    chunked_plain,
    launch_chunked,
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
              t_hi):
    """Diagonals 0..t_hi of the DP; directions (t_hi+1, B, W) uint8."""
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


@functools.lru_cache(maxsize=None)
def _base_tensor(R, D, W, device):
    return torch.from_numpy(band_bases(R, D, W)).to(device)


def _front(reads, r_lens, drafts, d_lens, W) -> bool:
    """The band check, then True for CPU tensors (plain version)."""
    _checked_bases(reads.shape[1], drafts.shape[1], W)
    return takes_plain(reads, r_lens, drafts, d_lens, W)


def _per_read(reads, drafts, W) -> int:
    return (reads.shape[1] + drafts.shape[1] + 1) * W


def _launch(name, reads, r_lens, drafts, d_lens, W, outs, extra):
    launch_chunked(name, LAUNCHES, reads, r_lens, drafts, d_lens, W,
                   _base_tensor(reads.shape[1], drafts.shape[1], W,
                                reads.device),
                   _per_read(reads, drafts, W), outs, extra)


def wavefront_dirs(reads, r_lens, drafts, d_lens, W, match, mismatch, gap):
    """The wavefront DP's direction tensor (T+1, B, W) uint8 on the
    tensors' device (row 0 zero).

    CPU tensors: :func:`wavefront_dirs_plain`.  CUDA tensors (uint8
    codes, int32 lengths, contiguous): the ``hx_wavefront_dirs`` kernel.
    The output is the whole tensor, so the batch is not chunked."""
    if _front(reads, r_lens, drafts, d_lens, W):
        return wavefront_dirs_plain(reads, r_lens, drafts, d_lens, W,
                                    match, mismatch, gap)
    from haslr_tpu_torch.kernels import _build

    B, R = reads.shape
    D = drafts.shape[1]
    dirs = torch.empty((R + D + 1, B, W), dtype=torch.uint8,
                       device=reads.device)
    err = _build.lib()["hx_wavefront_dirs"](
        reads.data_ptr(), r_lens.data_ptr(), drafts.data_ptr(),
        d_lens.data_ptr(), _base_tensor(R, D, W, reads.device).data_ptr(),
        dirs.data_ptr(), B, R, D, W, match, mismatch, gap,
        torch.cuda.current_stream(reads.device).cuda_stream,
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
            (match, mismatch, gap), _per_read(reads, drafts, W),
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
                             _per_read(reads, drafts, W))
    B = reads.shape[0]
    D = drafts.shape[1]
    planes = torch.full((B, 3 * D + 256), 4, dtype=torch.uint8,
                        device=reads.device)
    stats = torch.empty((B, 2), dtype=torch.int32, device=reads.device)
    _launch("wavefront_votes", reads, r_lens, drafts, d_lens, W,
            ((planes, 3 * D + 256), (stats, 8)), (match, mismatch, gap))
    return planes, stats
