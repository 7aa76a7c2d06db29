"""Binary snapshot indexes for assembler resume.

The reference writes raw struct dumps of its SoA arrays after the
expensive load stages and reloads them in preference to re-parsing
FASTA/PAF (``index.contig``: Contig.cpp:119-159, ``index.longread``:
Longread.cpp:322-372, consumed at main.cpp:39-52,65-103).  Here the same
snapshots are ``.npz`` archives of the flat store arrays plus a structured
alignment table with flattened CIGAR op/len streams.
"""

from __future__ import annotations

import numpy as np

from haslr_tpu_torch.assemble.contig_store import ContigStore
from haslr_tpu_torch.assemble.longread_store import Alignment, LongreadStore
from haslr_tpu_torch.core import seq as cseq

_ALN_FIELDS = [
    ("q_id", np.int64), ("q_start", np.int64), ("q_end", np.int64),
    ("t_id", np.int64), ("t_start", np.int64), ("t_end", np.int64),
    ("n_match", np.int64), ("n_block", np.int64), ("is_rev", np.int8),
    ("mapq", np.int16), ("t_len", np.int64),
]


def write_contig_index(path: str, contigs: ContigStore) -> None:
    np.savez_compressed(
        path,
        packed=contigs.seqs.packed,
        offsets=contigs.seqs.offsets,
        lengths=np.array(contigs.seqs.lengths, dtype=np.int64),
        kmer_count=np.array(contigs.kmer_count, dtype=np.int64),
        mean_kmer=np.array(contigs.mean_kmer, dtype=np.float64),
    )


def read_contig_index(path: str) -> ContigStore:
    z = np.load(path)
    store = ContigStore()
    store.seqs = cseq.SeqStore.from_flat(
        z["packed"], z["offsets"], z["lengths"]
    )
    store.kmer_count = [int(x) for x in z["kmer_count"]]
    store.mean_kmer = [float(x) for x in z["mean_kmer"]]
    return store


def write_longread_index(path: str, lrs: LongreadStore) -> None:
    alns = [a for read_alns in lrs.alignments for a in read_alns]
    table = np.zeros(len(alns), dtype=_ALN_FIELDS)
    for i, a in enumerate(alns):
        table[i] = (
            a.q_id, a.q_start, a.q_end, a.t_id, a.t_start, a.t_end,
            a.n_match, a.n_block, a.is_rev, a.mapq, a.t_len,
        )
    n_ops = np.array([len(a.ops) for a in alns], dtype=np.int64)
    ops = (
        np.concatenate([a.ops for a in alns])
        if alns else np.zeros(0, np.uint8)
    )
    lens = (
        np.concatenate([a.lens for a in alns])
        if alns else np.zeros(0, np.int64)
    )
    per_read = np.array([len(x) for x in lrs.alignments], dtype=np.int64)
    np.savez_compressed(
        path,
        packed=lrs.seqs.packed,
        offsets=lrs.seqs.offsets,
        lengths=np.array(lrs.seqs.lengths, dtype=np.int64),
        aln_table=table,
        aln_ops=ops,
        aln_lens=lens,
        aln_n_ops=n_ops,
        per_read=per_read,
    )


def read_longread_index(path: str) -> tuple[LongreadStore, int]:
    z = np.load(path)
    store = LongreadStore()
    store.seqs = cseq.SeqStore.from_flat(
        z["packed"], z["offsets"], z["lengths"]
    )
    table = z["aln_table"]
    ops = z["aln_ops"]
    lens = z["aln_lens"]
    op_off = np.concatenate([[0], np.cumsum(z["aln_n_ops"])])
    alns = []
    for i in range(len(table)):
        row = table[i]
        alns.append(
            Alignment(
                q_id=int(row["q_id"]), q_start=int(row["q_start"]),
                q_end=int(row["q_end"]), t_id=int(row["t_id"]),
                t_start=int(row["t_start"]), t_end=int(row["t_end"]),
                n_match=int(row["n_match"]), n_block=int(row["n_block"]),
                is_rev=int(row["is_rev"]), mapq=int(row["mapq"]),
                t_len=int(row["t_len"]),
                ops=ops[op_off[i] : op_off[i + 1]].copy(),
                lens=lens[op_off[i] : op_off[i + 1]].copy(),
            )
        )
    store.alignments = [[] for _ in range(len(store.seqs))]
    k = 0
    for rid, cnt in enumerate(z["per_read"]):
        for _ in range(int(cnt)):
            store.alignments[rid].append(alns[k])
            k += 1
    return store, len(alns)
