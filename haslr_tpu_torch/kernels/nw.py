"""Banded NW entry points and the engine switch (port of
:mod:`haslr_tpu.kernels.nw`).

:data:`ENGINE` selects the DP formulation of the production align paths,
as in the reference: ``"rowscan"`` (R row steps; the default) or
``"wavefront"`` (R+D anti-diagonal steps; the cross-check oracle).  It is
a module global read at call time, so flipping it changes the calls that
follow: ``align_mapping_device`` here, the extension
(:mod:`haslr_tpu_torch.aligner.extend`) and the consensus rounds
(:mod:`haslr_tpu_torch.kernels.consensus_dense`).

- :func:`align_mapping_device_raw` / :func:`align_mapping_device` — DP +
  traceback on the device, the (B, R) mapping: the row-scan
  ``hx_rowscan_mapping`` or the wavefront ``hx_wavefront_mapping`` kernel.
- :func:`align_mapping_device_sharded` — the same over a ``dp`` mesh,
  the rows split in blocks, one a device.
- :func:`banded_nw_batch` + :func:`traceback_batch` — the DP-only route:
  the wavefront direction tensor (``hx_wavefront_dirs``) copied to the
  host and walked there.
- :func:`nw_scores` — the score-only wavefront DP of the distributed
  support step (:mod:`haslr_tpu_torch.dist.consensus_step`); the
  reference computes it in XLA outside any Pallas kernel, so here it is
  plain PyTorch on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from haslr_tpu_torch.kernels.nw_rowscan import (
    DIAG,
    LEFT,
    NEG,
    UP,
    put_batch,
    rowscan_mapping,
)
from haslr_tpu_torch.kernels.nw_wavefront import (
    band_bases,
    wavefront_dirs,
    wavefront_mapping,
)

ENGINES = ("rowscan", "wavefront")
ENGINE = "rowscan"


def _resolve_engine(engine):
    engine = ENGINE if engine is None else engine
    if engine not in ENGINES:
        raise ValueError(f"unknown NW engine {engine!r} (one of {ENGINES})")
    return engine


def align_mapping_device_raw(reads, r_lens, drafts, d_lens, W=128, match=5,
                             mismatch=-4, gap=-8, device=None):
    """Align host (numpy) batches on ``device`` (the card unless the
    caller says ``"cpu"``) with the active engine; returns the (B, R)
    mapping as a DEVICE tensor (encoding of :func:`traceback_batch`),
    int16 when D <= 32000 (the insertion code -(j+2) must hold -(D+2)),
    else int32."""
    args = put_batch(device, reads, r_lens, drafts, d_lens)
    if _resolve_engine(None) == "rowscan":
        mapping = rowscan_mapping(*args, W, match, mismatch, gap)
    else:
        mapping = wavefront_mapping(*args, W, match, mismatch, gap)
    return mapping.to(torch.int16 if drafts.shape[1] <= 32000
                      else torch.int32)


def align_mapping_device(reads, r_lens, drafts, d_lens, W=128, match=5,
                         mismatch=-4, gap=-8, device=None) -> np.ndarray:
    """Host-array wrapper around :func:`align_mapping_device_raw`."""
    return align_mapping_device_raw(
        reads, r_lens, drafts, d_lens, W, match, mismatch, gap, device
    ).cpu().numpy()


def align_mapping_device_sharded(reads, r_lens, drafts, d_lens, mesh, W=128,
                                 match=5, mismatch=-4, gap=-8):
    """Data-parallel :func:`align_mapping_device_raw` over a
    :class:`~haslr_tpu_torch.dist.mesh.Mesh`: the rows split into
    contiguous blocks, one a mesh device, with no collective; every block
    is launched before any is collected.  Returns one device mapping a
    non-empty block, in row order."""
    return [
        align_mapping_device_raw(reads[a:b], r_lens[a:b], drafts[a:b],
                                 d_lens[a:b], W, match, mismatch, gap,
                                 device=dev)
        for (a, b), dev in zip(mesh.blocks(len(reads)), mesh.devices)
        if b > a
    ]


def nw_scores(reads, r_lens, drafts, d_lens, W=128, match=5, mismatch=-4,
              gap=-8):
    """Score-only banded NW over the anti-diagonals: each read's
    final-cell score (B,) int32, on the tensors' device.  The reference's
    recurrence step for step (two H diagonals carried, the final cell
    caught as its diagonal passes; empty pairs score 0), in plain PyTorch
    ops."""
    B, R = reads.shape
    D = drafts.shape[1]
    dev = reads.device
    base = band_bases(R, D, W)
    lanes = torch.arange(W, dtype=torch.int32, device=dev)
    rl = r_lens.to(torch.int32)
    dl = d_lens.to(torch.int32)
    neg = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    h_prev2, h_prev1 = neg, neg.clone()
    h_prev1[:, 0] = 0
    pad = torch.full((B, 1), 4, dtype=reads.dtype, device=dev)
    reads_p = torch.cat([reads, pad], 1)
    drafts_p = torch.cat([drafts, pad.to(drafts.dtype)], 1)
    negcol = neg[:, :1]
    best = torch.full((B,), NEG, dtype=torch.int32, device=dev)

    def shift(x, off):  # x[:, k + off], NEG outside the band
        off = min(max(off, -1), 2)  # t = 1: every diagonal-2 cell is NEG
        xp = torch.cat([negcol, x, negcol, negcol], 1)
        return xp[:, off + 1 : off + 1 + W]

    for t in range(1, R + D + 1):
        b_t = int(base[t])
        s1 = b_t - int(base[t - 1])
        s2 = b_t - int(base[t - 2])
        j = b_t + lanes
        i = t - j
        rb = reads_p[:, torch.clamp(i - 1, 0, R).long()]
        db = drafts_p[:, torch.clamp(j - 1, 0, D).long()]
        sub = torch.where(rb == db, match, mismatch).to(torch.int32)
        i_b, j_b = i[None, :], j[None, :]
        valid = (i_b >= 0) & (i_b <= rl[:, None]) & (j_b >= 0) \
            & (j_b <= dl[:, None])
        h = torch.maximum(
            torch.where((i_b >= 1) & (j_b >= 1), shift(h_prev2, s2 - 1)
                        + sub, NEG),
            torch.maximum(
                torch.where(i_b >= 1, shift(h_prev1, s1) + gap, NEG),
                torch.where(j_b >= 1, shift(h_prev1, s1 - 1) + gap, NEG),
            ),
        )
        h = torch.where(valid, h, NEG)
        lane_f = torch.clamp(dl - b_t, 0, W - 1).long()
        val = h.gather(1, lane_f[:, None])[:, 0]
        best = torch.where(rl + dl == t, val, best)
        h_prev2, h_prev1 = h_prev1, h
    return torch.where((rl == 0) & (dl == 0), 0, best)


def banded_nw_batch(reads, r_lens, drafts, d_lens, W=128, match=5,
                    mismatch=-4, gap=-8, device=None):
    """Align each read to its draft with the wavefront DP on ``device``
    (the card unless the caller says ``"cpu"``).
    Returns ``(dirs, base)``: the (T+1, B, W) direction tensor (numpy
    uint8) and the band offsets, ready for :func:`traceback_batch`."""
    R = reads.shape[1]
    D = drafts.shape[1]
    dirs = wavefront_dirs(*put_batch(device, reads, r_lens, drafts, d_lens),
                          W, match, mismatch, gap)
    return dirs.cpu().numpy(), band_bases(R, D, W)


def traceback_batch(dirs: np.ndarray, base: np.ndarray, r_lens: np.ndarray,
                    d_lens: np.ndarray, R_pad: int) -> np.ndarray:
    """Lockstep-batched host traceback (numpy copy of
    ``haslr_tpu.kernels.nw.traceback_batch``).

    Returns ``mapping`` (B, R_pad) int32: for read base index i,
      - ``mapping[b, i] = j``      — base aligned to draft position j;
      - ``mapping[b, i] = -(a+3)`` — base inserted after draft position a
        (a = -1 for insertions before the draft start);
      - ``-1`` marks unused positions (i >= r_len).
    """
    Bn = len(r_lens)
    W = dirs.shape[2]
    mapping = np.full((Bn, R_pad), -1, dtype=np.int32)
    i = r_lens.astype(np.int64).copy()
    j = d_lens.astype(np.int64).copy()
    bidx = np.arange(Bn)
    active = (i > 0) | (j > 0)
    while active.any():
        t = i + j
        lane = j - base[t]
        in_band = (lane >= 0) & (lane < W) & active
        d = np.full(Bn, LEFT, dtype=np.uint8)
        d[in_band] = dirs[t[in_band], bidx[in_band], lane[in_band]]
        d = np.where(active & (i == 0), LEFT, d)
        d = np.where(active & (j == 0), UP, d)
        is_diag = active & (d == DIAG)
        is_up = active & (d == UP)
        is_left = active & (d == LEFT)
        sel = is_diag
        mapping[bidx[sel], i[sel] - 1] = (j[sel] - 1).astype(np.int32)
        sel = is_up
        mapping[bidx[sel], i[sel] - 1] = (-(j[sel] + 2)).astype(np.int32)
        i -= is_diag | is_up
        j -= is_diag | is_left
        active = (i > 0) | (j > 0)
    return mapping
