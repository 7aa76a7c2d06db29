"""Native (C++) runtime components with lazy build + ctypes bindings.

The port's own copy of :mod:`haslr_tpu.native`: the same seven sources
and the same bindings.  The library is compiled on demand from the
sources in this directory (g++ -O3, linked against zlib) into the
package's ``_build/`` directory, under a name that carries a hash of the
sources and the flags, so an edited source is rebuilt and a stale
library is never loaded.  It exports the same ``hx_*`` names as the
reference's library; ``ctypes.CDLL`` binds them per handle, so one
process can hold both.  Every native entry point has a pure-Python
fallback, so the package works without a compiler; the native path
removes per-record Python overhead from the I/O hot loops (the role
kseq.h/zlib play in the reference)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SOURCES = [
    os.path.join(_DIR, "fastx.cpp"),
    os.path.join(_DIR, "dbg.cpp"),
    os.path.join(_DIR, "chain.cpp"),
    os.path.join(_DIR, "mapcig.cpp"),
    os.path.join(_DIR, "poa.cpp"),
    os.path.join(_DIR, "kmer.cpp"),
    os.path.join(_DIR, "paf.cpp"),
]
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_tried = False


def _target() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR,
                        f"libhaslr_native_{h.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        res = subprocess.run(
            ["g++", *_FLAGS, *_SOURCES, "-lz", "-o", tmp],
            capture_output=True, timeout=240,
        )
        if res.returncode == 0 and os.path.isfile(tmp):
            os.replace(tmp, so)  # atomic: concurrent builds agree
            return True
    except Exception:
        pass
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _target()
    if not os.path.isfile(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.hx_read_fastx.restype = ctypes.c_void_p
    lib.hx_read_fastx.argtypes = [ctypes.c_char_p]
    for fn in ("hx_n", "hx_codes_size", "hx_names_size", "hx_comments_size"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hx_codes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.hx_codes.argtypes = [ctypes.c_void_p]
    lib.hx_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.hx_offsets.argtypes = [ctypes.c_void_p]
    lib.hx_names.restype = ctypes.c_void_p
    lib.hx_names.argtypes = [ctypes.c_void_p]
    lib.hx_comments.restype = ctypes.c_void_p
    lib.hx_comments.argtypes = [ctypes.c_void_p]
    lib.hx_free.restype = None
    lib.hx_free.argtypes = [ctypes.c_void_p]
    # de Bruijn walker
    lib.hx_dbg_run.restype = ctypes.c_void_p
    lib.hx_dbg_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64, ctypes.c_int,
    ]
    for fn in ("hx_dbg_n_unitigs", "hx_dbg_seqs_size", "hx_dbg_n_links"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hx_dbg_seqs.restype = ctypes.c_void_p
    lib.hx_dbg_seqs.argtypes = [ctypes.c_void_p]
    for fn in ("hx_dbg_seq_offsets", "hx_dbg_kc", "hx_dbg_nk"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_uint64)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hx_dbg_links.restype = ctypes.POINTER(ctypes.c_int32)
    lib.hx_dbg_links.argtypes = [ctypes.c_void_p]
    lib.hx_dbg_free.restype = None
    lib.hx_dbg_free.argtypes = [ctypes.c_void_p]
    lib.hx_dbg_pop_run.restype = ctypes.c_void_p
    lib.hx_dbg_pop_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int,
    ]
    # canonical k-mer counting
    lib.hx_kmer_count.restype = ctypes.c_void_p
    lib.hx_kmer_count.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
    ]
    lib.hx_kmer_merge.restype = ctypes.c_void_p
    lib.hx_kmer_merge.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.hx_kmer_n.restype = ctypes.c_uint64
    lib.hx_kmer_n.argtypes = [ctypes.c_void_p]
    for fn in ("hx_kmer_hi", "hx_kmer_lo"):
        getattr(lib, fn).restype = ctypes.POINTER(ctypes.c_uint64)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.hx_kmer_cnt.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.hx_kmer_cnt.argtypes = [ctypes.c_void_p]
    lib.hx_kmer_free.restype = None
    lib.hx_kmer_free.argtypes = [ctypes.c_void_p]
    # anchor chaining
    lib.hx_chain_run.restype = ctypes.c_void_p
    lib.hx_chain_run.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int,
    ]
    lib.hx_chain_batch.restype = ctypes.c_void_p
    lib.hx_chain_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
    ]
    lib.hx_chain_group_ids.restype = ctypes.POINTER(ctypes.c_int64)
    lib.hx_chain_group_ids.argtypes = [ctypes.c_void_p]
    lib.hx_idx_lookup.restype = None
    lib.hx_idx_lookup.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.hx_chain_n.restype = ctypes.c_uint64
    lib.hx_chain_n.argtypes = [ctypes.c_void_p]
    lib.hx_chain_scores.restype = ctypes.POINTER(ctypes.c_double)
    lib.hx_chain_scores.argtypes = [ctypes.c_void_p]
    lib.hx_chain_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.hx_chain_offsets.argtypes = [ctypes.c_void_p]
    lib.hx_chain_indices.restype = ctypes.POINTER(ctypes.c_int64)
    lib.hx_chain_indices.argtypes = [ctypes.c_void_p]
    lib.hx_chain_free.restype = None
    lib.hx_chain_free.argtypes = [ctypes.c_void_p]
    # bulk PAF formatting + write
    lib.hx_paf_write.restype = ctypes.c_int64
    lib.hx_paf_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
    ]
    # batched CIGAR runs -> normalized CIGAR + n_eq
    lib.hx_runcig_run.restype = ctypes.c_void_p
    lib.hx_runcig_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
    ]
    # batched mapping -> CIGAR
    lib.hx_mapcig_run.restype = ctypes.c_void_p
    lib.hx_mapcig_run.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64,
    ]
    lib.hx_mapcig_size.restype = ctypes.c_uint64
    lib.hx_mapcig_size.argtypes = [ctypes.c_void_p]
    lib.hx_mapcig_ops.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.hx_mapcig_ops.argtypes = [ctypes.c_void_p]
    lib.hx_mapcig_lens.restype = ctypes.POINTER(ctypes.c_int64)
    lib.hx_mapcig_lens.argtypes = [ctypes.c_void_p]
    lib.hx_mapcig_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.hx_mapcig_offsets.argtypes = [ctypes.c_void_p]
    lib.hx_mapcig_neq.restype = ctypes.POINTER(ctypes.c_int64)
    lib.hx_mapcig_neq.argtypes = [ctypes.c_void_p]
    lib.hx_mapcig_free.restype = None
    lib.hx_mapcig_free.argtypes = [ctypes.c_void_p]
    # batched POA consensus
    lib.hx_poa_run.restype = ctypes.c_void_p
    lib.hx_poa_run.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.hx_poa_out_size.restype = ctypes.c_uint64
    lib.hx_poa_out_size.argtypes = [ctypes.c_void_p]
    lib.hx_poa_out.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.hx_poa_out.argtypes = [ctypes.c_void_p]
    lib.hx_poa_out_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.hx_poa_out_offsets.argtypes = [ctypes.c_void_p]
    lib.hx_poa_free.restype = None
    lib.hx_poa_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def poa_consensus_native(windows, match=5, mismatch=-4, gap=-8,
                         n_threads=1):
    """Batched POA consensus over ``windows`` (list of lists of 2-bit code
    arrays); returns a list of consensus code arrays, or None when the
    native library is unavailable (callers fall back to the Python
    engine).  Same semantics as :func:`haslr_tpu_torch.assemble.poa.poa_consensus`
    (SPOA call pattern of the reference, Assemble.cpp:499-555)."""
    lib = get_lib()
    if lib is None:
        return None
    seqs = []
    win_offsets = np.zeros(len(windows) + 1, dtype=np.uint64)
    for w, seq_list in enumerate(windows):
        seqs.extend(seq_list)
        win_offsets[w + 1] = len(seqs)
    seq_offsets = np.zeros(len(seqs) + 1, dtype=np.uint64)
    for i, s in enumerate(seqs):
        seq_offsets[i + 1] = seq_offsets[i] + len(s)
    codes = (
        np.concatenate([np.asarray(s, np.uint8) for s in seqs])
        if seqs else np.zeros(0, np.uint8)
    )
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    h = lib.hx_poa_run(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(seqs),
        win_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(windows), match, mismatch, gap, n_threads,
    )
    if not h:
        return None
    try:
        size = lib.hx_poa_out_size(h)
        out = (
            np.ctypeslib.as_array(lib.hx_poa_out(h), shape=(size,)).copy()
            if size else np.zeros(0, np.uint8)
        )
        offs = np.ctypeslib.as_array(
            lib.hx_poa_out_offsets(h), shape=(len(windows) + 1,)
        ).copy()
        return [out[offs[w] : offs[w + 1]] for w in range(len(windows))]
    finally:
        lib.hx_poa_free(h)


def mapping_cigars_native(mapping, reads, drafts, r_lens, d_lens):
    """Whole-chunk mapping->CIGAR conversion; returns a list of
    (ops, lens, n_eq) rows, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mapping = np.ascontiguousarray(mapping, dtype=np.int16)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    drafts = np.ascontiguousarray(drafts, dtype=np.uint8)
    rl = np.ascontiguousarray(r_lens, dtype=np.int32)
    dl = np.ascontiguousarray(d_lens, dtype=np.int32)
    B, R = mapping.shape
    S = reads.shape[1]
    h = lib.hx_mapcig_run(
        mapping.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        drafts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, R, S,
    )
    if not h:
        return None
    try:
        size = lib.hx_mapcig_size(h)
        ops = np.ctypeslib.as_array(lib.hx_mapcig_ops(h), shape=(size,)) \
            .copy() if size else np.zeros(0, np.uint8)
        lens = np.ctypeslib.as_array(lib.hx_mapcig_lens(h), shape=(size,)) \
            .copy() if size else np.zeros(0, np.int64)
        offs = np.ctypeslib.as_array(
            lib.hx_mapcig_offsets(h), shape=(B + 1,)
        ).copy()
        neq = np.ctypeslib.as_array(lib.hx_mapcig_neq(h), shape=(B,)).copy()
        return [
            (ops[offs[b] : offs[b + 1]], lens[offs[b] : offs[b + 1]],
             int(neq[b]))
            for b in range(B)
        ]
    finally:
        lib.hx_mapcig_free(h)


def runs_cigars_native(runs, n_runs, reads, drafts, r_lens, d_lens):
    """Whole-chunk CIGAR-run decode (reverse + normalize + n_eq); returns
    a list of (ops, lens, n_eq) rows — n_eq = -1 marks rows the caller
    must realign on host (run-count overflow) — or None when the library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    runs = np.ascontiguousarray(runs, dtype=np.uint16)
    nr = np.ascontiguousarray(n_runs, dtype=np.int32)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    drafts = np.ascontiguousarray(drafts, dtype=np.uint8)
    rl = np.ascontiguousarray(r_lens, dtype=np.int32)
    dl = np.ascontiguousarray(d_lens, dtype=np.int32)
    B, MAXR = runs.shape
    S = reads.shape[1]
    h = lib.hx_runcig_run(
        runs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        nr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        drafts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, MAXR, S,
    )
    if not h:
        return None
    try:
        size = lib.hx_mapcig_size(h)
        ops = np.ctypeslib.as_array(lib.hx_mapcig_ops(h), shape=(size,)) \
            .copy() if size else np.zeros(0, np.uint8)
        lens = np.ctypeslib.as_array(lib.hx_mapcig_lens(h), shape=(size,)) \
            .copy() if size else np.zeros(0, np.int64)
        offs = np.ctypeslib.as_array(
            lib.hx_mapcig_offsets(h), shape=(B + 1,)
        ).copy()
        neq = np.ctypeslib.as_array(lib.hx_mapcig_neq(h), shape=(B,)).copy()
        return [
            (ops[offs[b] : offs[b + 1]], lens[offs[b] : offs[b + 1]],
             int(neq[b]))
            for b in range(B)
        ]
    finally:
        lib.hx_mapcig_free(h)


def merge_kmer_native(parts, min_count):
    """K-way merge of per-shard sorted (hi, lo, count) streams (the
    multi-host SR counting merge); returns (hi, lo, counts) or None when
    the library is unavailable.  Semantics of
    ``kernels.kmer.merge_kmer_counts``: counts sum, filter after."""
    lib = get_lib()
    if lib is None:
        return None
    hi = np.ascontiguousarray(
        np.concatenate([p[0] for p in parts]), dtype=np.uint64
    )
    lo = np.ascontiguousarray(
        np.concatenate([p[1] for p in parts]), dtype=np.uint64
    )
    cnt = np.ascontiguousarray(
        np.concatenate([p[2] for p in parts]), dtype=np.int64
    )
    off = np.zeros(len(parts) + 1, np.uint64)
    np.cumsum([len(p[0]) for p in parts], out=off[1:])
    h = lib.hx_kmer_merge(
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(parts), min_count,
    )
    if not h:
        return None
    try:
        n = lib.hx_kmer_n(h)
        if n == 0:
            z = np.zeros(0, np.uint64)
            return z, z, np.zeros(0, np.int64)
        out_hi = np.ctypeslib.as_array(lib.hx_kmer_hi(h), shape=(n,)).copy()
        out_lo = np.ctypeslib.as_array(lib.hx_kmer_lo(h), shape=(n,)).copy()
        out_c = np.ctypeslib.as_array(
            lib.hx_kmer_cnt(h), shape=(n,)
        ).astype(np.int64)
        return out_hi, out_lo, out_c
    finally:
        lib.hx_kmer_free(h)


def idx_lookup_native(hashes_sorted, bstart, queries):
    """Bucketed equal-range lookup in a sorted uint64 hash array; returns
    (lo, hi) int64 arrays or None when the library is unavailable.
    ``bstart``: 65537 top-16-bit bucket prefix offsets."""
    lib = get_lib()
    if lib is None:
        return None
    hashes_sorted = np.ascontiguousarray(hashes_sorted, dtype=np.uint64)
    bstart = np.ascontiguousarray(bstart, dtype=np.uint64)
    q = np.ascontiguousarray(queries, dtype=np.uint64)
    m = len(q)
    lo = np.empty(m, np.int64)
    hi = np.empty(m, np.int64)
    lib.hx_idx_lookup(
        hashes_sorted.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        bstart.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        m,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return lo, hi


def paf_write_native(path, names, tnames, fields, ops_blob, lens_blob,
                     cig_off):
    """Bulk PAF write: ``names``/``tnames`` are str lists, ``fields`` an
    (n, 11) int64 array (see paf.cpp for the column layout), ops/lens the
    concatenated CIGAR runs with (n+1) offsets.  Returns the record count
    or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    nb = "".join(names).encode()
    n_off = np.zeros(len(names) + 1, np.uint64)
    np.cumsum([len(s.encode()) for s in names], out=n_off[1:])
    tb = "".join(tnames).encode()
    t_off = np.zeros(len(tnames) + 1, np.uint64)
    np.cumsum([len(s.encode()) for s in tnames], out=t_off[1:])
    fields = np.ascontiguousarray(fields, dtype=np.int64)
    ops_blob = np.ascontiguousarray(ops_blob, dtype=np.uint8)
    lens_blob = np.ascontiguousarray(lens_blob, dtype=np.int64)
    cig_off = np.ascontiguousarray(cig_off, dtype=np.uint64)
    rc = lib.hx_paf_write(
        path.encode(), nb,
        n_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), tb,
        t_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ops_blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens_blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cig_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(fields),
    )
    return None if rc < 0 else int(rc)


def chain_anchors_batch_native(t_pos, q_pos, group_off, k, window,
                               max_gap, min_score, min_anchors):
    """Chain EVERY (target, strand) group of one read in a single native
    call.  ``group_off``: (n_groups + 1) offsets into the flat sorted
    anchor arrays.  Returns ``(scores, group_ids, offsets, indices)``
    with chain anchor indices relative to their group's start, or None
    when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    t_pos = np.ascontiguousarray(t_pos, dtype=np.int64)
    q_pos = np.ascontiguousarray(q_pos, dtype=np.int64)
    group_off = np.ascontiguousarray(group_off, dtype=np.uint64)
    h = lib.hx_chain_batch(
        t_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        q_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        group_off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(group_off) - 1, k, window, max_gap, min_score, min_anchors,
    )
    if not h:
        return None
    try:
        n = lib.hx_chain_n(h)
        if n == 0:
            return (np.zeros(0), np.zeros(0, np.int64),
                    np.zeros(1, np.uint64), np.zeros(0, np.int64))
        scores = np.ctypeslib.as_array(
            lib.hx_chain_scores(h), shape=(n,)
        ).copy()
        gids = np.ctypeslib.as_array(
            lib.hx_chain_group_ids(h), shape=(n,)
        ).copy()
        offs = np.ctypeslib.as_array(
            lib.hx_chain_offsets(h), shape=(n + 1,)
        ).copy()
        total = int(offs[-1])
        idxs = np.ctypeslib.as_array(
            lib.hx_chain_indices(h), shape=(total,)
        ).copy() if total else np.zeros(0, np.int64)
        return scores, gids, offs, idxs
    finally:
        lib.hx_chain_free(h)


def chain_anchors_native(t_pos, q_pos, k, window, max_gap, min_score,
                         min_anchors):
    """Native chaining DP; returns [(score, indices)] or None when the
    library is unavailable (callers fall back to the numpy DP)."""
    lib = get_lib()
    if lib is None:
        return None
    t = np.ascontiguousarray(t_pos, dtype=np.int64)
    q = np.ascontiguousarray(q_pos, dtype=np.int64)
    h = lib.hx_chain_run(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(t), k, window, max_gap, float(min_score), min_anchors,
    )
    if not h:
        return None
    try:
        nc = lib.hx_chain_n(h)
        if nc == 0:
            return []
        scores = np.ctypeslib.as_array(
            lib.hx_chain_scores(h), shape=(nc,)
        ).copy()
        offs = np.ctypeslib.as_array(
            lib.hx_chain_offsets(h), shape=(nc + 1,)
        ).copy()
        idx = np.ctypeslib.as_array(
            lib.hx_chain_indices(h), shape=(int(offs[-1]),)
        ).copy()
        return [
            (float(scores[i]), idx[offs[i] : offs[i + 1]])
            for i in range(nc)
        ]
    finally:
        lib.hx_chain_free(h)


def count_kmers_native(codes, offsets, k: int, min_count: int = 1,
                       n_threads: int = 1):
    """Canonical k-mer counts over reads given as one flat 2-bit code
    array + record offsets (the native fastx reader's layout); returns
    sorted (hi, lo, counts) — the exact contract of
    ``kernels.kmer.count_kmers_host`` — or None when the native library
    is unavailable.

    This is the production single-host counting path (the minia stage,
    ``bin/haslr.py:180``): an O(1)-rolling canonical hash count with
    per-thread hash shards, no device round trips.  See native/kmer.cpp
    for why this beats the relay-bound device counter on this
    deployment."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    n_reads = len(offsets) - 1
    h = lib.hx_kmer_count(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_reads, k, min_count, n_threads,
    )
    if not h:
        return None
    try:
        n = lib.hx_kmer_n(h)
        if n == 0:
            z = np.zeros(0, np.uint64)
            return z, z, np.zeros(0, np.int64)
        hi = np.ctypeslib.as_array(lib.hx_kmer_hi(h), shape=(n,)).copy()
        lo = np.ctypeslib.as_array(lib.hx_kmer_lo(h), shape=(n,)).copy()
        cnt = np.ctypeslib.as_array(
            lib.hx_kmer_cnt(h), shape=(n,)
        ).astype(np.int64)
        return hi, lo, cnt
    finally:
        lib.hx_kmer_free(h)


def dbg_unitigs(hi, lo, cnt, k: int, pop_rounds: int = 0):
    """Native de Bruijn compaction; returns (seqs, kc, nk, links) or None
    when the library is unavailable.

    ``seqs`` is a list of unitig strings; ``links`` is an (n, 4) int32
    array of (from_uid, from_sign, to_uid, to_sign) with sign 0='+'.
    ``pop_rounds > 0`` runs iterative simple-bubble popping (delete the
    weaker branch's k-mers, re-compact) natively before emitting — the
    bounded-memory twin of ``sr.dbg.pop_bubbles``.
    """
    lib = get_lib()
    if lib is None:
        return None
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    cnt32 = np.ascontiguousarray(cnt, dtype=np.uint32)
    if pop_rounds > 0:
        h = lib.hx_dbg_pop_run(
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cnt32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(hi), k, pop_rounds,
        )
    else:
        h = lib.hx_dbg_run(
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cnt32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            len(hi), k,
        )
    if not h:
        return None
    try:
        nu = lib.hx_dbg_n_unitigs(h)
        blob = ctypes.string_at(lib.hx_dbg_seqs(h), lib.hx_dbg_seqs_size(h))
        offs = np.ctypeslib.as_array(
            lib.hx_dbg_seq_offsets(h), shape=(nu + 1,)
        ).copy()
        kc = np.ctypeslib.as_array(lib.hx_dbg_kc(h), shape=(nu,)).copy() \
            if nu else np.zeros(0, np.uint64)
        nk = np.ctypeslib.as_array(lib.hx_dbg_nk(h), shape=(nu,)).copy() \
            if nu else np.zeros(0, np.uint64)
        nl = lib.hx_dbg_n_links(h)
        if nl:
            links = np.ctypeslib.as_array(
                lib.hx_dbg_links(h), shape=(nl * 4,)
            ).copy().reshape(nl, 4)
        else:
            links = np.zeros((0, 4), np.int32)
        seqs = [
            blob[offs[i] : offs[i + 1]].decode() for i in range(nu)
        ]
        return seqs, kc, nk, links
    finally:
        lib.hx_dbg_free(h)


def read_fastx_encoded(path: str):
    """Parse FASTA/FASTQ into (codes, offsets, names, comments) using the
    native reader; returns None when the native library is unavailable or
    the file cannot be parsed (callers fall back to the Python reader).

    ``codes`` is one uint8 array of 2-bit codes; record i spans
    ``codes[offsets[i]:offsets[i+1]]``.
    """
    lib = get_lib()
    if lib is None:
        return None
    h = lib.hx_read_fastx(path.encode())
    if not h:
        return None
    try:
        n = lib.hx_n(h)
        ncodes = lib.hx_codes_size(h)
        if ncodes:
            codes = np.ctypeslib.as_array(
                lib.hx_codes(h), shape=(ncodes,)
            ).copy()
        else:
            codes = np.zeros(0, dtype=np.uint8)
        offsets = np.ctypeslib.as_array(
            lib.hx_offsets(h), shape=(n + 1,)
        ).copy()
        names_blob = ctypes.string_at(lib.hx_names(h), lib.hx_names_size(h))
        comments_blob = ctypes.string_at(
            lib.hx_comments(h), lib.hx_comments_size(h)
        )
        names = names_blob.decode().split("\0")[:n] if n else []
        comments = comments_blob.decode().split("\0")[:n] if n else []
        return codes, offsets.astype(np.int64), names, comments
    finally:
        lib.hx_free(h)
