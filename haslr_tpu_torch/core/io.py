"""Sequence file I/O: FASTA/FASTQ (plain or gzip), PAF, FOFN helpers.

CPU-side streaming readers feeding the device-friendly stores in
``haslr_tpu_torch.core.seq``.  Functional replacement for the reference's kseq.h
usage (``Contig.cpp:9-10``, ``Longread.cpp:10-11``) and PAF line splitting
(``Longread.cpp:234-302``); the parsing hot path has a C++ twin in
``haslr_tpu_torch/native`` used when the compiled library is available.
"""

from __future__ import annotations

import gzip
import io as _io
import os
from dataclasses import dataclass, field
from typing import Iterator


def _open_text(path: str):
    """Open a possibly-gzipped file for buffered text reading."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return _io.TextIOWrapper(
            _io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20)
        )
    return open(path, "rt", buffering=1 << 20)


@dataclass
class FastxRecord:
    name: str
    seq: str
    comment: str = ""
    qual: str | None = None


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream FASTA/FASTQ records (multi-line FASTA supported, gzip ok)."""
    with _open_text(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            # first header line (">" already consumed)
            header = fh.readline().rstrip("\n")
            name = comment = ""
            chunks: list[str] = []

            def set_header(h: str):
                nonlocal name, comment
                parts = h.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""

            set_header(header)
            for line in fh:
                if line.startswith(">"):
                    yield FastxRecord(name, "".join(chunks), comment)
                    set_header(line[1:].rstrip("\n"))
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield FastxRecord(name, "".join(chunks), comment)
            return
        elif first == "@":
            while True:
                header = fh.readline().rstrip("\n")
                seq = fh.readline().strip()
                plus = fh.readline()
                qual = fh.readline().strip()
                parts = header.split(None, 1)
                yield FastxRecord(
                    parts[0] if parts else "",
                    seq,
                    parts[1] if len(parts) > 1 else "",
                    qual,
                )
                nxt = fh.read(1)
                if nxt != "@":
                    return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def write_fasta(path: str, records, width: int = 0):
    """Write (name, seq) or (name, comment, seq) tuples as FASTA."""
    with open(path, "w") as fh:
        for rec in records:
            if len(rec) == 3:
                name, comment, seq = rec
                header = f">{name} {comment}" if comment else f">{name}"
            else:
                name, seq = rec
                header = f">{name}"
            fh.write(header + "\n")
            if width and width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i : i + width] + "\n")
            else:
                fh.write(seq + "\n")


def read_fofn(path: str) -> list[str]:
    with open(path) as fh:
        return [ln.strip() for ln in fh if ln.strip()]


@dataclass
class PafRecord:
    """One PAF alignment line (minimap2 format with cg:Z CIGAR tag).

    Field numbering follows the reference's column accesses
    (``Longread.cpp:262-289``): q_name/len/start/end, strand, t_name/len/
    start/end, n_match (col 10), n_block (col 11), mapq (col 12).
    """

    q_name: str
    q_len: int
    q_start: int
    q_end: int
    strand: str
    t_name: str
    t_len: int
    t_start: int
    t_end: int
    n_match: int
    n_block: int
    mapq: int
    tags: dict = field(default_factory=dict)

    @property
    def cigar(self) -> str:
        return self.tags.get("cg", "")

    def to_line(self) -> str:
        cols = [
            self.q_name, str(self.q_len), str(self.q_start), str(self.q_end),
            self.strand,
            self.t_name, str(self.t_len), str(self.t_start), str(self.t_end),
            str(self.n_match), str(self.n_block), str(self.mapq),
        ]
        for k, v in self.tags.items():
            t = {"cg": "Z", "tp": "A", "NM": "i"}.get(k, "Z")
            cols.append(f"{k}:{t}:{v}")
        return "\t".join(cols)


def parse_paf_line(line: str) -> PafRecord:
    f = line.rstrip("\n").split("\t")
    tags = {}
    for col in f[12:]:
        if len(col) > 5 and col[2] == ":" and col[4] == ":":
            tags[col[:2]] = col[5:]
    return PafRecord(
        f[0], int(f[1]), int(f[2]), int(f[3]), f[4],
        f[5], int(f[6]), int(f[7]), int(f[8]),
        int(f[9]), int(f[10]), int(f[11]), tags,
    )


def read_paf(path: str) -> Iterator[PafRecord]:
    with _open_text(path) as fh:
        for line in fh:
            if line.strip():
                yield parse_paf_line(line)


def file_exists(path: str) -> bool:
    return os.path.isfile(path)
