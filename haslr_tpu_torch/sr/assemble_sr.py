"""Short-read assembly stage: reads → solid k-mers → unitig/contig FASTA.

The port's copy of :mod:`haslr_tpu.sr.assemble_sr`, the minia-stage
driver (reference ``bin/haslr.py:160-200``: ``minia -kmer-size 49
-abundance-min 3 -no-ec-removal``).  Counting runs in the native C++
counter (``native/kmer.cpp``); compaction on host
(:mod:`haslr_tpu_torch.sr.dbg`).  The reference's device k-mer counters
(``kernels/kmer.py``, ``kernels/kmer_stream.py``) and its sharded merge
are not ported yet (ROADMAP A7, A5): the branches that reach them raise
:class:`RuntimeError` here.

``asm_type="contigs"`` additionally clips short low-coverage tips from the
unitig graph before re-compaction (minia's contig-level simplification);
``"unitigs"`` emits the raw compacted graph.
"""

from __future__ import annotations

import time

import numpy as np

from haslr_tpu_torch.core import io as cio
from haslr_tpu_torch.core import seq as cseq
from haslr_tpu_torch.sr import dbg

# wall-clock of the last assemble_short_reads call, by phase (count /
# compact / write); PROF.clear() to reset — mirrors kmer_stream.PROF
PROF: dict[str, float] = {}


def _not_ported(what: str, item: str):
    return RuntimeError(
        f"{what} is not ported yet (ROADMAP {item}); the short-read stage "
        "of haslr_tpu_torch needs the native library "
        "(haslr_tpu_torch/native, built with g++ -lz) and k <= 64"
    )


def load_read_codes(paths: list[str]) -> np.ndarray:
    """Concatenate all reads as 2-bit codes with SEP=4 separators (native
    C++ reader when available)."""
    from haslr_tpu_torch import native

    chunks = []
    for path in paths:
        nat = native.read_fastx_encoded(path)
        if nat is not None:
            codes, offsets, _n, _c = nat
            n = len(offsets) - 1
            # insert a separator after every record in one vectorized pass:
            # element e of record i lands at e + i
            out = np.full(len(codes) + n, 4, dtype=np.uint8)
            lens = np.diff(offsets)
            idx = np.arange(len(codes)) + np.repeat(np.arange(n), lens)
            out[idx] = codes
            chunks.append(out)
        else:
            for rec in cio.read_fastx(path):
                chunks.append(cseq.encode(rec.seq))
                chunks.append(np.array([4], dtype=np.uint8))
    if not chunks:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(chunks)


def iter_read_codes(paths: list[str]):
    """Yield each read's 2-bit codes (no separators) — the streaming twin
    of :func:`load_read_codes` for inputs too large to concatenate."""
    from haslr_tpu_torch import native

    for path in paths:
        nat = native.read_fastx_encoded(path)
        if nat is not None:
            codes, offsets, _n, _c = nat
            for i in range(len(offsets) - 1):
                yield codes[offsets[i] : offsets[i + 1]]
        else:
            for rec in cio.read_fastx(path):
                yield cseq.encode(rec.seq)


def _clip_tips(unitigs, k: int, min_tip_len: int | None = None,
               rel_cov: float = 0.5):
    """Drop tip unitigs: short, dead-ended on one side, and weaker than the
    neighborhood mean abundance.  Returns the surviving unitig list
    (re-numbered, links rebuilt by string matching is unnecessary: we
    simply drop the dropped ids from links)."""
    if min_tip_len is None:
        min_tip_len = 3 * k
    by_id = {u.uid: u for u in unitigs}
    drop = set()
    for u in unitigs:
        sides = {s for s, _, _ in u.links}
        dead_end = len(sides) < 2
        if not dead_end or len(u.seq) >= min_tip_len:
            continue
        neigh = [by_id[t].km for _, t, _ in u.links if t != u.uid]
        if neigh and u.km < rel_cov * float(np.mean(neigh)):
            drop.add(u.uid)
    if not drop:
        return unitigs
    kept = []
    remap = {}
    for u in unitigs:
        if u.uid in drop:
            continue
        remap[u.uid] = len(kept)
        kept.append(u)
    for u in kept:
        u.links = [
            (a, remap[t], c) for a, t, c in u.links if t in remap
        ]
        u.uid = remap[u.uid]
    return kept


# above this many input bases the single-shot device counter (which pads
# the whole stream into one array) gives way to the chunked streaming
# counter with bounded device/host memory
STREAMING_THRESHOLD = 1 << 28


def _load_flat(read_paths):
    """All reads as one flat 2-bit code array + offsets (native fastx
    layout); None when the native library is unavailable."""
    from haslr_tpu_torch import native

    parts = []
    for path in read_paths:
        nat = native.read_fastx_encoded(path)
        if nat is None:
            return None
        codes, offsets, _n, _c = nat
        parts.append((codes, offsets))
    if len(parts) == 1:
        return parts[0]
    codes = np.concatenate([p[0] for p in parts])
    offs = [parts[0][1]]
    base = len(parts[0][0])
    for p in parts[1:]:
        offs.append(p[1][1:] + base)
        base += len(p[0])
    return codes, np.concatenate(offs)


def _count_native(read_paths, kmer_size, min_abundance):
    """Native host counting over the fastx reader's flat layout; None
    when the native library is unavailable."""
    import os

    from haslr_tpu_torch import native

    flat = _load_flat(read_paths)
    if flat is None:
        return None
    codes, offsets = flat
    return native.count_kmers_native(
        codes, offsets, kmer_size, min_abundance,
        n_threads=os.cpu_count() or 1,
    )


def _count_native_sharded(read_paths, kmer_size, min_abundance,
                          n_shards):
    """The reference's multi-host SR counting path (native counting per
    shard + ``kernels.kmer.merge_kmer_counts``): lands with the
    multi-device port."""
    raise _not_ported("the sharded k-mer merge (merge_kmer_counts)", "A5")


def assemble_short_reads(
    read_paths: list[str],
    out_fasta: str,
    kmer_size: int = 49,
    min_abundance: int = 3,
    asm_type: str = "contigs",
    device: bool = True,
    streaming: bool | None = None,
    spill_dir: str | None = None,
    mesh=None,
) -> int:
    """SR assembly stage.  Counting-engine selection:

    - single host: the native host counter (production path — see
      native/kmer.cpp);
    - ``mesh`` set: native host counting per shard + prefix-range merge
      (the multi-host production path, bit-identical to single-host);
    - ``streaming=True`` (or no native library, or k > 64): the
      reference's device counters, which the port does not have yet —
      :class:`RuntimeError`.
    """
    PROF.clear()
    t0 = time.time()
    if streaming is None:
        import os

        if kmer_size <= 64:
            if mesh is None:
                counted = _count_native(read_paths, kmer_size,
                                        min_abundance)
                engine = "native"
            else:
                counted = _count_native_sharded(
                    read_paths, kmer_size, min_abundance,
                    int(mesh.devices.size),
                )
                engine = "native_sharded"
            if counted is not None:
                hi, lo, cnt = counted
                PROF["count_engine"] = engine
                return _finish(hi, lo, cnt, kmer_size, asm_type,
                               out_fasta, t0)
        total = sum(os.path.getsize(p) for p in read_paths)
        streaming = device and (total > STREAMING_THRESHOLD
                                or mesh is not None)
    if streaming:
        raise _not_ported("the streaming device k-mer counter "
                          "(kernels/kmer_stream.py)", "A7")
    raise _not_ported("the device and numpy k-mer counters "
                      "(kernels/kmer.py)", "A7")


def _finish(hi, lo, cnt, kmer_size, asm_type, out_fasta, t0) -> int:
    PROF["count"] = time.time() - t0
    PROF["n_solid"] = float(len(hi))
    t0 = time.time()
    if asm_type == "contigs":
        # minia's contig-level simplification: coverage-ranked simple-
        # bubble popping (het SNPs / error bulges), then tip clipping
        unitigs = dbg.pop_bubbles(hi, lo, cnt, kmer_size)
        unitigs = _clip_tips(unitigs, kmer_size)
    else:
        unitigs = dbg.unitigs_from_counts(hi, lo, cnt, kmer_size)
    PROF["compact"] = time.time() - t0
    t0 = time.time()
    dbg.write_unitigs_fasta(unitigs, out_fasta)
    PROF["write"] = time.time() - t0
    return len(unitigs)
