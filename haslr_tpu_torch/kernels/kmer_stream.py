"""Streaming canonical k-mer counting on a torch device, with bounded
device and host memory (port of :mod:`haslr_tpu.kernels.kmer_stream`).

The single-shot counter (:func:`haslr_tpu_torch.kernels.kmer.
count_kmers_device`) holds the whole concatenated read stream on the
device at once; this one takes reads in chunks and works at any input
size, in the reference's two phases:

1. **Distribute.**  Reads stream through the device in chunks of about
   ``chunk_bases`` (2-bit packed on the host, :func:`pack2`, one copy a
   chunk with its read offsets); each chunk's k-mers are canonicalized,
   sorted and run-length counted there (:func:`_count_chunk`), so the
   coverage within a chunk collapses before anything else happens.  The
   chunk's distinct (k-mer, count) rows then go

   - while they fit ``device_rows_budget`` (and neither ``spill_dir``
     nor ``mesh`` is given), into a DEVICE-RESIDENT accumulator of fixed
     capacity, which merges itself in place when it fills
     (``_self_compact``) and, when even its distinct rows leave no room,
     moves to the host store (``_spill_acc_to_host``);
   - else into 4^p host partitions keyed by the top ``2*prefix_bits``
     bits of the canonical k-mer (:class:`_PartitionStore`, optionally
     spilled to ``spill_dir``).
2. **Count.**  The accumulator is merged once (sort by the k-mer words,
   counts summed by run, abundance filter: :func:`_merge_rows`); or the
   partitions are, consecutive ones in groups on one device, or one
   partition a device of ``mesh`` with no collective.  Partitions are
   prefix-ordered, so their outputs concatenate into the globally
   sorted stream: the contract of ``count_kmers_host``.

A row is the k-mer's int64 words (:func:`haslr_tpu_torch.kernels.kmer.
_word_spans`, 31 bases each) and its count: a ``(n_words + 1, n)`` int64
array, the counts last.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from haslr_tpu_torch.kernels.kmer import (
    _canonical_words,
    _check_k,
    _empty_counts,
    _run_counts,
    _sort_rows,
    _word_spans,
    _words_to_pair,
)

# host-side wall-clock accounting of the last count_kmers_streaming call
# (phase1_pack_dispatch / phase1_device / phase1_acc / phase1_d2h_split /
# acc_compact / acc_spill / phase2_merge); PROF.clear() to reset
PROF: dict[str, float] = {}


def _prof(key, t0):
    PROF[key] = PROF.get(key, 0.0) + time.time() - t0


def pack2(codes: np.ndarray) -> np.ndarray:
    """2-bit pack (4 codes/byte, LSB-first) for the host->device hop."""
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    g = (codes & 3).reshape(-1, 4)
    return (g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)) \
        .astype(np.uint8)


def _count_chunk(packed, offsets, k, device):
    """Distinct canonical k-mer rows of one chunk at ``min_count=1``,
    sorted, on ``device``.  ``packed``: the chunk's codes (:func:`pack2`);
    ``offsets``: int64 read offsets (0, each read's end), every read at
    least k long.  A k-mer that crosses a read boundary is left out: a
    boundary flag's prefix sum counts the boundaries strictly inside it
    (an offset equal to the length has no k-mer across it)."""
    n = int(offsets[-1])
    m = n - k + 1
    p = torch.from_numpy(packed).to(device)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=device)
    codes = ((p[:, None] >> shifts) & 3).reshape(-1)[:n]
    inner = offsets[(offsets > 0) & (offsets < n)]
    flags = torch.zeros(n, dtype=torch.int32, device=device)
    flags[torch.from_numpy(inner).to(device)] = 1
    csum = torch.cumsum(flags, 0, dtype=torch.int32)
    valid = (csum[k - 1 : k - 1 + m] - csum[:m]) == 0
    del flags, csum
    words, _ = _sort_rows(_canonical_words(codes, k, valid))
    words, counts = _run_counts(words, 1)
    return torch.stack(words + [counts])


def _merge_rows(rows, min_count):
    """Merge pre-counted rows (a ``(n_words + 1, n)`` tensor, any order)
    on their device: sort by the k-mer words, sum the counts of equal
    k-mers, keep those with at least ``min_count``."""
    words, (counts,) = _sort_rows(list(rows[:-1]), rows[-1])
    words, counts = _run_counts(words, min_count, counts)
    return torch.stack(words + [counts])


class _PartitionStore:
    """Per-partition (words, counts) row buffers, RAM or disk-backed."""

    def __init__(self, n_parts: int, n_words: int, spill_dir=None):
        self.n_parts = n_parts
        self.n_words = n_words
        self.spill_dir = spill_dir
        self.mem: list[list[np.ndarray]] = [[] for _ in range(n_parts)]
        self.files: list[list[str]] = [[] for _ in range(n_parts)]
        self._file_no = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def add(self, pid: int, rows: np.ndarray):
        if rows.shape[1] == 0:
            return
        if self.spill_dir:
            path = os.path.join(
                self.spill_dir, f"part{pid}_{self._file_no}.npy"
            )
            self._file_no += 1
            np.save(path, rows)
            self.files[pid].append(path)
        else:
            self.mem[pid].append(rows)

    def take(self, pid: int) -> np.ndarray:
        """All rows of one partition, concatenated; frees the buffers."""
        chunks = list(self.mem[pid])
        for path in self.files[pid]:
            chunks.append(np.load(path))
            os.remove(path)
        self.mem[pid] = []
        self.files[pid] = []
        if not chunks:
            return np.zeros((self.n_words + 1, 0), np.uint32)
        return np.concatenate(chunks, axis=1)


def count_kmers_streaming(
    reads,
    k: int,
    min_count: int = 1,
    chunk_bases: int = 1 << 24,
    prefix_bits: int = 4,
    spill_dir: str | None = None,
    mesh=None,
    device_rows_budget: int = 1 << 27,
    device: torch.device | str | None = None,
):
    """Canonical k-mer counts over an iterable of read code arrays, on
    ``device`` (the card unless the caller says ``"cpu"``).

    Same output contract as ``count_kmers_host``: (hi, lo, counts), the
    distinct canonical k-mers in sorted order with count >= min_count.

    Two regimes.  While the accumulated chunk rows fit
    ``device_rows_budget`` rows (and no mesh/spill is requested),
    everything stays on the device and only the final distinct rows
    cross to the host; a full accumulator first merges itself, and
    spills to the host store when its distinct rows still leave no room
    for the next chunk.  With ``spill_dir`` or ``mesh`` (or after a
    spill), rows go to the prefix-partitioned host/disk store, bounded
    in memory at any scale.

    ``mesh``: optional :class:`~haslr_tpu_torch.dist.mesh.Mesh`; the
    chunks are counted on its first device, and phase 2 merges
    ``mesh.size`` prefix partitions at a time, one a device (disjoint
    prefix ranges: no collective), with the single-device output."""
    from haslr_tpu_torch.dist.mesh import as_mesh

    _check_k(k)
    spans = _word_spans(k)
    n_words = len(spans)
    first_word_bases = spans[0][1] - spans[0][0]
    prefix_bits = min(prefix_bits, first_word_bases)
    shift = 2 * first_word_bases - 2 * prefix_bits
    n_parts = 1 << (2 * prefix_bits)
    store = _PartitionStore(n_parts, n_words, spill_dir)
    sharded = mesh is not None
    mesh = as_mesh(device, mesh)
    home = mesh.devices[0]

    # --- device-resident accumulator: rows [:, :acc_n] of acc ----------
    device_mode = spill_dir is None and not sharded
    acc = None
    acc_n = 0

    def _store_rows(rows):
        """Split sorted host rows by prefix into the host store."""
        pids = rows[0] >> shift
        bounds = np.searchsorted(pids, np.arange(n_parts + 1))
        for pid in range(n_parts):
            lo_i, hi_i = bounds[pid], bounds[pid + 1]
            if hi_i > lo_i:
                store.add(pid, rows[:, lo_i:hi_i])

    def _self_compact():
        """Merge the accumulator in place at min_count=1: acc_n shrinks
        to the distinct rows so far, so the device path takes any input
        whose DISTINCT k-mers fit the budget."""
        nonlocal acc_n
        t0 = time.time()
        merged = _merge_rows(acc[:, :acc_n], 1)
        acc_n = merged.shape[1]
        acc[:, :acc_n] = merged
        _prof("acc_compact", t0)

    def _spill_acc_to_host():
        """Budget exceeded: the accumulator's rows (one sorted run, as it
        was just compacted) go to the host store, and the run goes on in
        host mode."""
        nonlocal device_mode, acc
        t0 = time.time()
        if acc_n:
            _store_rows(acc[:, :acc_n].cpu().numpy())
        acc = None
        device_mode = False
        _prof("acc_spill", t0)

    def add_rows(rows, n_starts):
        """One chunk's rows into the accumulator, or the host store."""
        nonlocal acc, acc_n
        n = rows.shape[1]
        if device_mode:
            if acc is None:
                # one allocation: 16 chunks of k-mer starts of headroom
                # before the first self-compaction, clamped to the budget
                acc = torch.empty(
                    (n_words + 1, min(device_rows_budget, 16 * n_starts)),
                    dtype=torch.int64, device=home)
            if acc_n + n > acc.shape[1] and acc_n:
                _self_compact()
            if acc_n + n <= acc.shape[1]:
                t0 = time.time()
                acc[:, acc_n : acc_n + n] = rows
                acc_n += n
                _prof("phase1_acc", t0)
                return
            # even compacted, the distinct rows leave no room
            _spill_acc_to_host()
        t0 = time.time()
        _store_rows(rows.cpu().numpy())
        _prof("phase1_d2h_split", t0)

    # ---- phase 1: distribute ------------------------------------------
    buf: list[np.ndarray] = []
    buf_len = 0

    def flush():
        nonlocal buf, buf_len
        if not buf:
            return
        t0 = time.time()
        codes = np.concatenate(buf)
        offsets = np.zeros(len(buf) + 1, np.int64)
        np.cumsum([len(b) for b in buf], out=offsets[1:])
        buf, buf_len = [], 0
        packed = pack2(codes)
        _prof("phase1_pack_dispatch", t0)
        t0 = time.time()
        rows = _count_chunk(packed, offsets, k, home)
        _prof("phase1_device", t0)
        add_rows(rows, len(codes) - k + 1)

    for codes in reads:
        if len(codes) < k:
            continue
        if buf_len and buf_len + len(codes) > chunk_bases:
            flush()
        buf.append(np.asarray(codes, np.uint8))
        buf_len += len(codes)
    flush()

    # ---- phase 2: merge -------------------------------------------------
    his, los, cnts = [], [], []

    def emit(rows):
        rows = rows.cpu().numpy()
        if rows.shape[1]:
            hi, lo = _words_to_pair(list(rows[:-1]), k)
            his.append(hi)
            los.append(lo)
            cnts.append(rows[-1])

    t0 = time.time()
    if device_mode:
        # one device merge of the accumulator; the only copy to the host
        # is the final distinct rows
        if acc is not None:
            emit(_merge_rows(acc[:, :acc_n], min_count))
            acc = None
    elif not sharded:
        # CONSECUTIVE partitions merge together, about group_rows rows a
        # device merge: partition p's k-mers all precede partition p+1's,
        # so a joint sort of a prefix-contiguous group emits the same
        # globally sorted stream in a few merges instead of n_parts
        group_rows = 1 << 23
        pending: list[np.ndarray] = []
        pending_m = 0

        def merge_pending():
            nonlocal pending, pending_m
            if pending_m:
                rows = np.concatenate(pending, axis=1)
                pending, pending_m = [], 0
                emit(_merge_rows(torch.from_numpy(rows).to(home),
                                 min_count))

        for pid in range(n_parts):
            rows = store.take(pid)
            if rows.shape[1] == 0:
                continue
            if pending_m and pending_m + rows.shape[1] > group_rows:
                merge_pending()
            pending.append(rows)
            pending_m += rows.shape[1]
        merge_pending()
    else:
        # one partition a mesh device, disjoint prefix ranges: no
        # collective; emitted in partition order
        for lo_pid in range(0, n_parts, mesh.size):
            group = [store.take(pid) for pid in
                     range(lo_pid, min(lo_pid + mesh.size, n_parts))]
            for rows, dev in zip(group, mesh.devices):
                if rows.shape[1]:
                    emit(_merge_rows(torch.from_numpy(rows).to(dev),
                                     min_count))
    _prof("phase2_merge", t0)
    if not his:
        return _empty_counts()
    return (
        np.concatenate(his),
        np.concatenate(los),
        np.concatenate(cnts),
    )
