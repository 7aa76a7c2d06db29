"""Read mapping: seed -> chain -> extend -> PAF (port of
:func:`haslr_tpu.aligner.map.map_reads`).

The host phases are the reference's and are shared: minimizer index,
seeding and chaining (sharded over ``threads`` worker processes), CIGAR
assembly and the native PAF writer.  Only the extension runs here, on
the torch device (:func:`haslr_tpu_torch.aligner.extend.
batch_align_segments`).

The shared writer's count is not trusted: the native writer ignores the
results of ``fwrite`` and ``fclose``, so a short write still reports
every record.  :func:`map_reads` counts the records in the file and
raises when the two differ.
"""

from __future__ import annotations

import time

import torch

from haslr_tpu.aligner.index import MinimizerIndex
from haslr_tpu.aligner.map import (
    PRESETS,
    _emit_all,
    _load_contigs,
    _seed_chain_segments,
    _seed_chain_shards,
)
from haslr_tpu.core import io as cio
from haslr_tpu.core import seq as cseq

# wall clock of the last map_reads call by phase (seed_chain / extend /
# emit, extension sub-phases under "extend.")
PROF: dict[str, float] = {}


def map_reads(
    contig_fasta: str,
    reads_fasta: str,
    out_paf: str,
    read_type: str = "pacbio",
    min_chain_score: float = 40.0,
    threads: int = 1,
    device: torch.device | str = "cpu",
) -> int:
    """Map all reads; writes PAF; returns the record count.  Same
    contract as the reference's ``map_reads`` (``minimap2 -t T
    --secondary=no -c {preset} contigs lr``), with the extension on
    ``device``.  One host only: the reference's ``host_shard`` waits for
    the multi-device port."""
    from haslr_tpu_torch.aligner import extend

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
