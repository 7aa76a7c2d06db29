"""Trim (k-1)/2 bp from contig ends that have de Bruijn neighbors.

Replaces ``minia_nooverlap`` (reference ``src/minia_nooverlap/
nooverlap.cpp:30-89``): adjacent minia contigs share (k-1)-base overlaps;
any end with an incoming (``L:-``) or outgoing (``L:+``) link is trimmed by
``(k-1)/2`` so neighbors no longer overlap.  Headers pass through
unchanged, matching the reference output.
"""

from __future__ import annotations

from haslr_tpu_torch.core import io as cio


def remove_overlaps(in_fasta: str, out_fasta: str, kmer_size: int) -> int:
    overlap_len = kmer_size - 1
    trim = overlap_len // 2
    n = 0
    with open(out_fasta, "w") as fp:
        for rec in cio.read_fastx(in_fasta):
            # reference skips the first three comment tokens (LN/KC/km) and
            # reads the remaining link fields' sign at position 2
            tokens = rec.comment.split()
            incoming = outgoing = False
            for link in tokens[3:]:
                if len(link) > 2:
                    if link[2] == "+":
                        outgoing = True
                    elif link[2] == "-":
                        incoming = True
            seq = rec.seq
            if incoming:
                seq = seq[trim:]
            if outgoing:
                # the reference computes the kept length in size_t
                # (nooverlap.cpp:80): when the remaining sequence is
                # SHORTER than the trim, size()-trim wraps and substr
                # clamps, leaving the sequence untouched — pinned by
                # tests/test_nooverlap_crossval.py against the compiled
                # reference binary
                seq = seq[: len(seq) - trim] if len(seq) >= trim else seq
            fp.write(f">{rec.name} {rec.comment}\n{seq}\n")
            n += 1
    return n
