"""Read mapping: seed -> chain -> extend -> PAF (port of
:mod:`haslr_tpu.aligner.map`).

The host phases are the port's own copy of the reference's: anchor
collection, chaining and greedy chain acceptance (sharded over
``threads`` worker processes, which import this module), CIGAR assembly
and the native PAF writer.  Only the extension differs: it runs on the
torch device (:func:`haslr_tpu_torch.aligner.extend.
batch_align_segments`).

The writer's count is not trusted: the native writer ignores the
results of ``fwrite`` and ``fclose``, so a short write still reports
every record.  :func:`map_reads` counts the records in the file and
raises when the two differ.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from haslr_tpu_torch.aligner import minimizer as mz
from haslr_tpu_torch.aligner.chain import chain_anchors
from haslr_tpu_torch.aligner.index import MinimizerIndex
from haslr_tpu_torch.core import cigar as ccigar
from haslr_tpu_torch.core import io as cio
from haslr_tpu_torch.core import seq as cseq

# wall clock of the last map_reads call by phase (seed_chain / extend /
# emit, extension sub-phases under "extend.")
PROF: dict[str, float] = {}

# read type -> (k, w, homopolymer-compression), mirroring bin/haslr.py:90-95
PRESETS = {
    "corrected": (19, 10, False),
    "pacbio": (17, 10, True),
    "nanopore": (15, 10, False),
}


def map_reads(
    contig_fasta: str,
    reads_fasta: str,
    out_paf: str,
    read_type: str = "pacbio",
    min_chain_score: float = 40.0,
    threads: int = 1,
    device: torch.device | str | None = None,
) -> int:
    """Map all reads; writes PAF; returns the record count.  Same
    contract as the reference's ``map_reads`` (``minimap2 -t T
    --secondary=no -c {preset} contigs lr``), with the extension on
    ``device`` (the card unless the caller says ``"cpu"``).  One host
    only: the reference's ``host_shard`` waits for the multi-device
    port."""
    from haslr_tpu_torch.aligner import extend
    from haslr_tpu_torch.device import resolve_device

    device = resolve_device(device)
    k, w, hpc = PRESETS[read_type]
    contig_names, contig_codes = _load_contigs(contig_fasta)

    PROF.clear()
    t0 = time.time()
    if threads > 1:
        pending, segments = _seed_chain_shards(
            contig_fasta, reads_fasta, read_type, min_chain_score, threads,
        )
    else:
        idx = MinimizerIndex.build(contig_codes, k, w, hpc)

        def reads():
            for ri, rec in enumerate(cio.read_fastx(reads_fasta)):
                yield ri, rec.name, cseq.encode(rec.seq)

        pending, segments = _seed_chain_segments(
            idx, contig_codes, reads(), min_chain_score
        )
    PROF["seed_chain"] = time.time() - t0
    PROF["n_segments"] = float(len(segments))

    t0 = time.time()
    seg_results = extend.batch_align_segments(segments, device=device)
    PROF["extend"] = time.time() - t0
    PROF.update({f"extend.{k2}": v for k2, v in extend.PROF.items()})
    t0 = time.time()
    n = _emit_all(pending, seg_results, contig_names, contig_codes, out_paf)
    n_file = count_records(out_paf)
    if n_file != n:
        raise OSError(f"{out_paf}: the PAF writer reported {n} records but "
                      f"the file holds {n_file} (a short or failed write)")
    PROF["emit"] = time.time() - t0
    return n


def count_records(path: str) -> int:
    """Newline-terminated records in a text file, read in 1 MiB chunks."""
    n = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            n += chunk.count(b"\n")
    return n


# --------------------------------------------------------------------------
# host phases: the port's copy of haslr_tpu.aligner.map's
# --------------------------------------------------------------------------


def collect_anchors(idx: MinimizerIndex, codes: np.ndarray):
    """All (contig_id, rel_strand, t_pos, q_pos) anchors for one read,
    grouped by (contig, relative strand).

    Returns ``(cids, rels, group_off, t, q)``: per-group contig id and
    strand plus (n_groups + 1) offsets into the flat anchor arrays,
    which are sorted by (cid, rel, t, q) — so each group's slice is
    sorted by (t, q), the chaining DP's input contract.  ``q_pos`` is in
    the frame of the read orientation that matches the target forward
    strand (for rel_strand==1 a position on the reverse-complemented
    read); conversion back to original read coordinates happens at PAF
    emission.
    """
    rlen = len(codes)
    z = np.zeros(0, np.int64)
    h, qp, qe, qs = mz.minimizers(codes, idx.k, idx.w, idx.hpc)
    lo, hi = idx.lookup(h)
    occ = hi - lo
    keep = (occ > 0) & (occ <= idx.max_occ)
    if not keep.any():
        return z, z, np.zeros(1, np.int64), z, z
    l, c = lo[keep], (hi - lo)[keep]
    total = int(c.sum())
    # enumerate all index entries of all kept seeds in one shot
    starts = np.concatenate([[0], np.cumsum(c)[:-1]])
    flat = np.repeat(l, c) + (np.arange(total) - np.repeat(starts, c))
    cid = idx.contig_ids[flat]
    rel = np.repeat(qs[keep], c) ^ idx.strands[flat]
    t = idx.positions[flat]
    # on the revcomp read the k-mer starts at rlen - end; under HPC the
    # span exceeds k, so the true end matters
    q = np.where(
        rel == 0, np.repeat(qp[keep], c), rlen - np.repeat(qe[keep], c)
    )
    # group by (contig, rel strand)
    order = np.lexsort((q, t, rel, cid))
    cid, rel, t, q = cid[order], rel[order], t[order], q[order]
    boundary = np.concatenate(
        [[True], (cid[1:] != cid[:-1]) | (rel[1:] != rel[:-1])]
    )
    g0 = np.nonzero(boundary)[0]
    group_off = np.concatenate([g0, [total]]).astype(np.int64)
    return (cid[g0].astype(np.int64), rel[g0].astype(np.int64),
            group_off, t.astype(np.int64), q.astype(np.int64))


def accept_chains(idx, codes, min_chain_score=40.0, min_anchors=3):
    """Chain anchors in every (contig, strand) group and greedily accept
    chains with <50% query overlap, tracking the best comparable
    competitor per accepted chain for MAPQ.  Returns rows
    ``[score, f2, cid, rel, t_arr, q_arr, (qs, qe)]``.

    All of a read's groups chain in ONE native call
    (``native.chain_anchors_batch_native``) — the per-group ctypes
    crossing was ~44% of the whole seed+chain phase at the 50 Mb tier
    (6.8M tiny calls)."""
    from haslr_tpu_torch import native

    rlen = len(codes)
    cids, rels, group_off, t_all, q_all = collect_anchors(idx, codes)
    all_chains = []  # (score, cid, rel, t_arr, q_arr)
    batch = (
        native.chain_anchors_batch_native(
            t_all, q_all, group_off, idx.k, 50, 5000, min_chain_score,
            min_anchors,
        )
        if len(cids)
        else (np.zeros(0), np.zeros(0, np.int64), np.zeros(1, np.uint64),
              np.zeros(0, np.int64))
    )
    if batch is not None:
        scores, gids, offs, idxs = batch
        for ci in range(len(scores)):
            g = int(gids[ci])
            base = group_off[g]
            sel = base + idxs[offs[ci] : offs[ci + 1]]
            all_chains.append((
                float(scores[ci]), int(cids[g]), int(rels[g]),
                t_all[sel], q_all[sel],
            ))
    else:
        for g in range(len(cids)):
            sl = slice(group_off[g], group_off[g + 1])
            chains = chain_anchors(
                t_all[sl], q_all[sl], idx.k,
                min_score=min_chain_score, min_anchors=min_anchors,
            )
            base = group_off[g]
            for score, sel in chains:
                all_chains.append((
                    score, int(cids[g]), int(rels[g]),
                    t_all[base + sel], q_all[base + sel],
                ))
    all_chains.sort(key=lambda c: -c[0])
    accepted = []
    for score, cid, rel, t_arr, q_arr in all_chains:
        qs, qe = int(q_arr.min()), int(q_arr.max()) + idx.k
        if rel == 1:
            qs, qe = rlen - qe, rlen - qs
        overlapped = None
        for acc in accepted:
            a_qs, a_qe = acc[6]
            ov = min(qe, a_qe) - max(qs, a_qs)
            if ov > 0.5 * min(qe - qs, a_qe - a_qs):
                overlapped = acc
                break
        if overlapped is None:
            accepted.append([score, 0.0, cid, rel, t_arr, q_arr, (qs, qe)])
        elif score >= 0.25 * overlapped[0]:
            # sub-chain crumbs of the winner score far below it and say
            # nothing about mapping ambiguity; only comparable competitors
            # (true alternative placements) lower MAPQ
            overlapped[1] = max(overlapped[1], score)
    return accepted


def _emit_record(name, rlen, rel, cid, contig_names, t_codes, q_arr, t_arr,
                 ops, lens, n_match, score, f2):
    q_beg = int(q_arr[0])
    q_end = q_beg + ccigar.query_len(ops, lens)
    t_beg = int(t_arr[0])
    t_end = t_beg + ccigar.target_len(ops, lens)
    n_block = ccigar.n_columns(ops, lens)
    n = len(t_arr)
    mapq = int(
        min(60, 60.0 * (1.0 - f2 / max(score, 1e-9)) * min(1.0, n / 10))
    )
    if rel == 0:
        qs_out, qe_out = q_beg, q_end
    else:
        qs_out, qe_out = rlen - q_end, rlen - q_beg
    return cio.PafRecord(
        q_name=name,
        q_len=rlen,
        q_start=qs_out,
        q_end=qe_out,
        strand="-" if rel else "+",
        t_name=contig_names[cid],
        t_len=len(t_codes),
        t_start=t_beg,
        t_end=t_end,
        n_match=n_match,
        n_block=n_block,
        mapq=mapq,
        tags={"tp": "P", "cg": ccigar.to_string(ops, lens)},
    )


def map_read(
    idx: MinimizerIndex,
    codes: np.ndarray,
    name: str,
    contig_codes: list,
    contig_names: list,
    min_chain_score: float = 40.0,
    min_anchors: int = 3,
) -> list[cio.PafRecord]:
    rlen = len(codes)
    if rlen < idx.k:
        return []
    rc = cseq.revcomp_codes(codes)
    accepted = accept_chains(idx, codes, min_chain_score, min_anchors)
    # extend + emit (host path; map_reads batches segments on device)
    records = []
    for score, f2, cid, rel, t_arr, q_arr, (qs0, qe0) in accepted:
        q_codes = codes if rel == 0 else rc
        t_codes = contig_codes[cid]
        order = np.argsort(t_arr, kind="stable")
        t_arr, q_arr = t_arr[order], q_arr[order]
        ops, lens, n_match = chain_to_cigar(
            q_codes, t_codes, q_arr, t_arr, idx.k,
            exact_anchors=not idx.hpc,
        )
        records.append(
            _emit_record(name, rlen, rel, cid, contig_names, t_codes,
                         q_arr, t_arr, ops, lens, n_match, score, f2)
        )
    records.sort(key=lambda r: (r.q_start, r.q_end))
    return records


def _seed_chain_segments(idx, contig_codes, reads, min_chain_score):
    """Phase 1 for a stream of reads: seed + chain + decompose chains into
    literal parts and NW segments.  Pure host work (numpy + the native
    chaining DP) — no device involvement, so it shards across plain
    worker processes while the device stays with the caller.

    ``reads`` yields ``(ri, name, codes)`` with ``ri`` the global read
    index (used to restore file order at emission).  Returns ``(pending,
    segments)``; pending rows are ``(ri, name, rlen, rel, cid, q_arr,
    t_arr, parts, seg_base, score, f2)`` with NW part indices relative to
    ``seg_base``.
    """
    from haslr_tpu_torch.aligner.extend import chain_to_segments

    pending = []
    segments = []
    for ri, name, codes in reads:
        rlen = len(codes)
        if rlen < idx.k:
            continue
        rc = cseq.revcomp_codes(codes)
        for score, f2, cid, rel, t_arr, q_arr, _span in accept_chains(
            idx, codes, min_chain_score
        ):
            q_codes = codes if rel == 0 else rc
            t_codes = contig_codes[cid]
            order = np.argsort(t_arr, kind="stable")
            t_arr, q_arr = t_arr[order], q_arr[order]
            parts, segs = chain_to_segments(
                q_codes, t_codes, q_arr, t_arr, idx.k,
                exact_anchors=not idx.hpc,
            )
            pending.append(
                (ri, name, rlen, rel, cid, q_arr, t_arr, parts,
                 len(segments), score, f2)
            )
            segments.extend(segs)
    return pending, segments


def _emit_all(pending, seg_results, contig_names, contig_codes, out_paf):
    """Phase 3: assemble CIGARs, restore read-file order, write PAF.

    Field math mirrors :func:`_emit_record`; the formatting + file write
    happen in ONE native call (``native/paf.cpp`` — byte-identical to
    ``PafRecord.to_line``), with the Python writer as fallback.  A
    stable sort on (read index, q_start, q_end) reproduces the
    per-read ordering exactly."""
    from haslr_tpu_torch import native
    from haslr_tpu_torch.aligner.extend import assemble_parts

    rows = []
    for (ri, name, rlen, rel, cid, q_arr, t_arr, parts, seg_base, score,
         f2) in pending:
        ops, lens, n_match = assemble_parts(parts, seg_results, seg_base)
        q_beg = int(q_arr[0])
        q_end = q_beg + ccigar.query_len(ops, lens)
        t_beg = int(t_arr[0])
        t_end = t_beg + ccigar.target_len(ops, lens)
        n_block = ccigar.n_columns(ops, lens)
        mapq = int(
            min(60, 60.0 * (1.0 - f2 / max(score, 1e-9))
                * min(1.0, len(t_arr) / 10))
        )
        if rel == 0:
            qs_out, qe_out = q_beg, q_end
        else:
            qs_out, qe_out = rlen - q_end, rlen - q_beg
        rows.append((
            ri, qs_out, qe_out, name,
            (rlen, qs_out, qe_out, rel, cid, len(contig_codes[cid]),
             t_beg, t_end, n_match, n_block, mapq),
            ops, lens,
        ))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    n = len(rows)
    if n:
        fields = np.array([r[4] for r in rows], np.int64)
        names = [r[3] for r in rows]
        ops_blob = np.concatenate([r[5] for r in rows])
        lens_blob = np.concatenate([r[6] for r in rows])
        cig_off = np.zeros(n + 1, np.uint64)
        np.cumsum([len(r[5]) for r in rows], out=cig_off[1:])
        rc = native.paf_write_native(
            out_paf, names, contig_names, fields, ops_blob, lens_blob,
            cig_off,
        )
        if rc is not None:
            return rc
    with open(out_paf, "w") as fp:
        for ri, qs_out, qe_out, name, fld, ops, lens in rows:
            (rlen, _qs, _qe, rel, cid, t_len, t_beg, t_end, n_match,
             n_block, mapq) = fld
            pr = cio.PafRecord(
                q_name=name, q_len=rlen, q_start=qs_out, q_end=qe_out,
                strand="-" if rel else "+", t_name=contig_names[cid],
                t_len=t_len, t_start=t_beg, t_end=t_end, n_match=n_match,
                n_block=n_block, mapq=mapq,
                tags={"tp": "P", "cg": ccigar.to_string(ops, lens)},
            )
            fp.write(pr.to_line() + "\n")
    return n


def _load_contigs(contig_fasta):
    contig_names = []
    contig_codes = []
    for rec in cio.read_fastx(contig_fasta):
        contig_names.append(rec.name)
        contig_codes.append(cseq.encode(rec.seq))
    return contig_names, contig_codes


def _shard_worker(args):
    (contig_fasta, reads_fasta, read_type, min_chain_score, shard_idx,
     n_shards, host_shard) = args
    # phase 1 only: pure host work, no jax import, no device claim
    k, w, hpc = PRESETS[read_type]
    _, contig_codes = _load_contigs(contig_fasta)
    idx = MinimizerIndex.build(contig_codes, k, w, hpc)
    sh_i, sh_n = host_shard if host_shard is not None else (0, 1)

    def reads():
        for ri, rec in enumerate(cio.read_fastx(reads_fasta)):
            if ri % sh_n == sh_i and (ri // sh_n) % n_shards == shard_idx:
                yield ri, rec.name, cseq.encode(rec.seq)

    return _seed_chain_segments(idx, contig_codes, reads(), min_chain_score)


def _seed_chain_shards(
    contig_fasta, reads_fasta, read_type, min_chain_score, threads,
    host_shard=None,
):
    """Run phase 1 across worker processes; returns merged (pending,
    segments) with segment bases rebased onto the concatenated list."""
    import multiprocessing as mp

    args = [
        (contig_fasta, reads_fasta, read_type, min_chain_score, i, threads,
         host_shard)
        for i in range(threads)
    ]
    ctx = mp.get_context("spawn")
    with ctx.Pool(threads) as pool:
        shards = pool.map(_shard_worker, args)
    pending = []
    segments = []
    for sh_pending, sh_segments in shards:
        base = len(segments)
        for row in sh_pending:
            pending.append(row[:8] + (row[8] + base,) + row[9:])
        segments.extend(sh_segments)
    return pending, segments
