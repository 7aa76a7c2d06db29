"""Base-level extension on a torch device (port of
:func:`haslr_tpu.aligner.extend.batch_align_segments`).

Gap segments between chain anchors are length-bucketed exactly as in the
reference (S a power of two >= 128, W = 128 / 256 / 512) and aligned on
the device by the active engine (:data:`haslr_tpu_torch.kernels.nw.
ENGINE`), as in the reference:

- ``"rowscan"`` (default): the row-scan CIGAR-run traceback
  (:func:`haslr_tpu_torch.kernels.nw_rowscan.cigar_runs_device_raw`),
  decoded on host by the shared native run decoder;
- ``"wavefront"``: the mapping branch — the (B, S) read->draft mapping
  (:func:`haslr_tpu_torch.kernels.nw.align_mapping_device_raw`), narrowed
  to int16 on the device before the copy and decoded on host by
  ``native.mapping_cigars_native`` (or ``mapping_to_cigar`` without the
  library).

The host fallbacks are the reference's:
:func:`haslr_tpu.aligner.extend.nw_cigar` for short, empty,
band-incompatible (``|lq - lt| >= W/2 - 4``) or S > 16384 segments and
for rows whose run list overflowed MAXR.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from haslr_tpu import native
from haslr_tpu.aligner.extend import (
    _decode_runs_py,
    mapping_to_cigar,
    nw_cigar,
)
from haslr_tpu_torch.kernels import nw
from haslr_tpu_torch.kernels import nw_rowscan as rsk
from haslr_tpu_torch.kernels.consensus_dense import _band_width

# per-phase wall clock of the last batch_align_segments call
PROF: dict[str, float] = {}


def batch_align_segments(segments, match=2, mismatch=-4, gap=-2,
                         device: torch.device | str = "cpu"):
    """Globally align many (q_codes, t_codes) segment pairs; returns a
    list of (ops, lens, n_eq) parallel to ``segments``."""
    device = torch.device(device)
    PROF.clear()

    def _prof(key, dt):
        PROF[key] = PROF.get(key, 0.0) + dt

    t0 = time.time()
    results = [None] * len(segments)
    buckets: dict[int, list[int]] = {}
    for i, (q, t) in enumerate(segments):
        lq, lt = len(q), len(t)
        if lq == 0 or lt == 0 or max(lq, lt) < 16:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        S = 128
        while S < max(lq, lt):
            S *= 2
        if abs(lq - lt) >= _band_width(S) // 2 - 4 or S > 16384:
            results[i] = nw_cigar(q, t, match, mismatch, gap)
            continue
        buckets.setdefault(S, []).append(i)
    _prof("host_small", time.time() - t0)

    use_runs = nw._resolve_engine(None) == "rowscan"
    # queue every chunk's kernel before collecting any: the copies back
    # and the host decode of one chunk overlap later chunks' kernels
    in_flight = []
    for S, idxs in sorted(buckets.items()):
        W = _band_width(S)
        max_b = 32
        while max_b * 2 * (2 * S + 1) * W <= (256 << 20):
            max_b *= 2
        for lo in range(0, len(idxs), max_b):
            chunk = idxs[lo : lo + max_b]
            t0 = time.time()
            B = len(chunk)
            reads = np.full((B, S), 4, dtype=np.uint8)
            drafts = np.full((B, S), 4, dtype=np.uint8)
            r_lens = np.zeros(B, dtype=np.int32)
            d_lens = np.zeros(B, dtype=np.int32)
            for k, i in enumerate(chunk):
                q, t = segments[i]
                reads[k, : len(q)] = q
                drafts[k, : len(t)] = t
                r_lens[k] = len(q)
                d_lens[k] = len(t)
            _prof("pack", time.time() - t0)
            t0 = time.time()
            if use_runs:
                dev = rsk.cigar_runs_device_raw(
                    reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
                    device=device,
                )
            else:
                # int16 on the device (S <= 16384), as the native decoder
                # takes it: half the copy of int32
                dev = nw.align_mapping_device_raw(
                    reads, r_lens, drafts, d_lens, W, match, mismatch, gap,
                    device=device,
                )
            in_flight.append((chunk, dev, reads, drafts, r_lens, d_lens))
            _prof("dispatch", time.time() - t0)
    for chunk, dev, reads, drafts, r_lens, d_lens in in_flight:
        if not use_runs:
            _collect_mapping(chunk, dev, reads, drafts, r_lens, d_lens,
                             segments, results, _prof)
            continue
        runs_dev, nruns_dev = dev
        t0 = time.time()
        runs = runs_dev.cpu().numpy().astype(np.uint16)
        nruns = nruns_dev.cpu().numpy()
        _prof("collect_d2h", time.time() - t0)
        t0 = time.time()
        rows = native.runs_cigars_native(runs, nruns, reads, drafts, r_lens,
                                         d_lens)
        if rows is None:
            rows = [
                _decode_runs_py(runs[k], int(nruns[k]), *segments[i])
                for k, i in enumerate(chunk)
            ]
        for k, i in enumerate(chunk):
            o, l, ne = rows[k]
            if ne < 0:  # run-count overflow: realign on host
                results[i] = nw_cigar(*segments[i], match, mismatch, gap)
                _prof("n_runs_overflow", 1)
            else:
                results[i] = (o, l, ne)
        _prof("convert", time.time() - t0)
    return results


def _collect_mapping(chunk, mapping_dev, reads, drafts, r_lens, d_lens,
                     segments, results, prof):
    """Copy one chunk's int16 mapping back and decode its CIGARs."""
    t0 = time.time()
    mapping = mapping_dev.cpu().numpy()
    prof("collect_d2h", time.time() - t0)
    t0 = time.time()
    rows = native.mapping_cigars_native(mapping, reads, drafts, r_lens,
                                        d_lens)
    if rows is None:
        rows = [mapping_to_cigar(mapping[k], *segments[i])
                for k, i in enumerate(chunk)]
    for k, i in enumerate(chunk):
        results[i] = rows[k]
    prof("convert", time.time() - t0)
