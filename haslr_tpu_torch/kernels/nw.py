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
- :func:`banded_nw_batch` + :func:`traceback_batch` — the DP-only route:
  the wavefront direction tensor (``hx_wavefront_dirs``) copied to the
  host and walked there.

Left for the multi-device slice: ``nw_scores`` and the sharded align.
"""

from __future__ import annotations

import numpy as np
import torch

from haslr_tpu_torch.kernels.nw_rowscan import (
    DIAG,
    LEFT,
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
