"""Short-read contig store: sequences + minia-style k-mer metadata.

Replaces the reference's ``Contig_List_t`` loader (``Contig.cpp:43-117``):
contigs are 2-bit packed into one flat buffer, and each carries the minia
header tags ``KC:i:`` (k-mer count) and ``km:f:`` (mean k-mer abundance)
that drive the uniqueness filters downstream.
"""

from __future__ import annotations

import numpy as np

from haslr_tpu_torch.core import io as cio
from haslr_tpu_torch.core import seq as cseq


class ContigStore:
    def __init__(self):
        self.seqs = cseq.SeqStore()
        self.kmer_count: list[int] = []
        self.mean_kmer: list[float] = []

    def __len__(self):
        return len(self.seqs)

    @property
    def lengths(self) -> list[int]:
        return self.seqs.lengths

    def add(self, seq: str, kmer_count: int = 0, mean_kmer: float = 0.0) -> int:
        cid = self.seqs.add_str(seq)
        self.kmer_count.append(int(kmer_count))
        self.mean_kmer.append(float(mean_kmer))
        return cid

    def get_codes(self, cid: int) -> np.ndarray:
        return self.seqs.get(cid)

    def get_str(self, cid: int) -> str:
        return self.seqs.get_str(cid)

    def length(self, cid: int) -> int:
        return self.seqs.lengths[cid]

    @classmethod
    def load_fasta(cls, path: str) -> "ContigStore":
        """Load contigs with KC/km tags from a minia-style FASTA.

        Tag parsing mirrors ``Contig.cpp:63-66`` (strstr on the comment);
        contig ids are assigned by file order, matching the reference's
        assumption that minimap2 target names equal those ordinal ids.
        Uses the native C++ reader when available.
        """
        store = cls()

        def add_codes(codes, comment):
            kc, km = 0, 0.0
            p = comment.find("KC:i:")
            if p >= 0:
                kc = int(comment[p + 5 :].split()[0])
            p = comment.find("km:f:")
            if p >= 0:
                km = float(comment[p + 5 :].split()[0])
            store.seqs.add(codes)
            store.kmer_count.append(kc)
            store.mean_kmer.append(km)

        from haslr_tpu_torch import native

        nat = native.read_fastx_encoded(path)
        if nat is not None:
            codes, offsets, _names, comments = nat
            for i, comment in enumerate(comments):
                add_codes(codes[offsets[i] : offsets[i + 1]], comment)
        else:
            for rec in cio.read_fastx(path):
                add_codes(cseq.encode(rec.seq), rec.comment)
        return store

    def calc_uniq_freq(self) -> float:
        """Mean k-mer frequency of the 20 longest contigs.

        Reference ``calc_uniq_freq`` (``Contig.cpp:162-174``): sort
        (len, mean_kmer) pairs descending and average ``mean_kmer`` over the
        top 20 (fewer if the assembly is small).  This estimates the k-mer
        frequency of unique (single-copy) genomic regions, the yardstick for
        every repeat filter downstream.
        """
        n = len(self)
        if n == 0:
            return 0.0
        pairs = sorted(
            zip(self.seqs.lengths, self.mean_kmer),
            key=lambda p: (p[0], p[1]),
            reverse=True,
        )
        top = pairs[: min(20, n)]
        return float(sum(p[1] for p in top) / len(top))
