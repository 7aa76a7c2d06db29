"""De Bruijn graph compaction: solid k-mers → unitigs/contigs with minia-
style metadata.

Replaces the minia stage (reference ``bin/haslr.py:160-200``): counting is
done by :mod:`haslr_tpu_torch.kernels.kmer` (device or host path); this module
walks the bidirected de Bruijn graph of solid canonical k-mers into maximal
non-branching unitigs and emits FASTA with the header tags downstream
stages parse — ``KC:i:`` total k-mer count and ``km:f:`` mean abundance
(``Contig.cpp:63-66``) and ``L:<sign>:<id>:<sign>`` adjacency links
(``nooverlap.cpp:56-71``).

Graph walking is host-side by design (pointer chasing over a ~10^5-10^7
node graph, SURVEY.md §7.1); k-mers are arbitrary-precision ints (2k bits).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np



# reverse-complement table for 8-base (16-bit) chunks, built vectorized
def _build_r8() -> list:
    x = np.arange(1 << 16, dtype=np.uint32)
    out = np.zeros(1 << 16, dtype=np.uint32)
    for _ in range(8):
        out = (out << 2) | (3 - (x & 3))
        x >>= 2
    return out.tolist()


_R8 = _build_r8()


def rc_int(v: int, k: int) -> int:
    """Reverse complement of a 2k-bit packed k-mer int (8 bases per table
    lookup; the remainder bases via the plain 2-bit loop)."""
    out = 0
    full, rem = divmod(k, 8)
    for _ in range(full):
        out = (out << 16) | _R8[v & 0xFFFF]
        v >>= 16
    for _ in range(rem):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


def kmer_to_str(v: int, k: int) -> str:
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


@dataclass
class Unitig:
    uid: int
    seq: str
    kc: int          # sum of member k-mer counts (minia KC:i:)
    first: int       # first oriented k-mer value
    last: int        # last oriented k-mer value
    links: list = field(default_factory=list)  # (from_sign, to_id, to_sign)
    kc_positions: int = 0  # number of member k-mers

    @property
    def km(self) -> float:
        """Mean k-mer abundance (minia km:f:)."""
        return self.kc / max(1, self.kc_positions)


class DeBruijnGraph:
    def __init__(self, k: int, counts: dict[int, int]):
        self.k = k
        self.mask = (1 << (2 * k)) - 1
        self.counts = counts  # canonical kmer int -> count
        self._canon_cache: dict[int, int] = {}

    @classmethod
    def from_pairs(cls, hi: np.ndarray, lo: np.ndarray, cnt: np.ndarray,
                   k: int) -> "DeBruijnGraph":
        counts = {}
        for h, l, c in zip(hi.tolist(), lo.tolist(), cnt.tolist()):
            counts[(int(h) << 64) | int(l)] = int(c)
        return cls(k, counts)

    def canon(self, v: int) -> int:
        c = self._canon_cache.get(v)
        if c is None:
            r = rc_int(v, self.k)
            c = r if r < v else v
            self._canon_cache[v] = c
        return c

    def succs(self, v: int) -> list[int]:
        """Oriented right extensions of oriented k-mer v present in graph."""
        base = (v << 2) & self.mask
        out = []
        for b in range(4):
            w = base | b
            if self.canon(w) in self.counts:
                out.append(w)
        return out

    def preds(self, v: int) -> list[int]:
        """Oriented left extensions (as oriented k-mers ending before v)."""
        return [rc_int(w, self.k) for w in self.succs(rc_int(v, self.k))]

    # -- unitig construction ------------------------------------------------

    def _is_start(self, v: int) -> bool:
        p = self.preds(v)
        if len(p) != 1:
            return True
        # unique predecessor; if it branches forward, v starts a unitig
        return len(self.succs(p[0])) != 1

    def build_unitigs(self) -> list[Unitig]:
        visited: set[int] = set()
        unitigs: list[Unitig] = []

        def walk(v0: int):
            k = self.k
            chars = [kmer_to_str(v0, k)]
            kc = self.counts[self.canon(v0)]
            n_kmers = 1
            visited.add(self.canon(v0))
            v = v0
            while True:
                s = self.succs(v)
                if len(s) != 1:
                    break
                w = s[0]
                if len(self.preds(w)) != 1:
                    break
                cw = self.canon(w)
                if cw in visited:
                    break  # cycle closure
                visited.add(cw)
                chars.append("ACGT"[w & 3])
                kc += self.counts[cw]
                n_kmers += 1
                v = w
            u = Unitig(len(unitigs), "".join(chars), kc, v0, v)
            u.kc_positions = n_kmers
            unitigs.append(u)

        # pass 1: from unitig-start kmers, both orientations
        for cv in list(self.counts):
            for v in (cv, rc_int(cv, self.k)):
                if self.canon(v) in visited:
                    break
                if self._is_start(v):
                    walk(v)
                    break
        # pass 2: leftovers are perfect cycles
        for cv in list(self.counts):
            if cv not in visited:
                walk(cv)

        self._attach_links(unitigs)
        return unitigs

    def _attach_links(self, unitigs: list[Unitig]):
        # map end k-mers (canonical) -> (uid, which ends they are)
        canon_of = {}
        for u in unitigs:
            canon_of[self.canon(u.first)] = canon_of.get(
                self.canon(u.first), []
            ) + [u.uid]
            canon_of.setdefault(self.canon(u.last), [])
            if u.uid not in canon_of[self.canon(u.last)]:
                canon_of[self.canon(u.last)].append(u.uid)

        def resolve(w: int):
            """Which unitig end does oriented k-mer w correspond to?"""
            cw = self.canon(w)
            for uid in canon_of.get(cw, []):
                u2 = unitigs[uid]
                if w == u2.first:
                    return uid, "+"
                if w == rc_int(u2.last, self.k):
                    return uid, "-"
            return None

        for u in unitigs:
            for w in self.succs(u.last):
                r = resolve(w)
                if r:
                    u.links.append(("+", r[0], r[1]))
            for w in self.succs(rc_int(u.first, self.k)):
                r = resolve(w)
                if r:
                    u.links.append(("-", r[0], r[1]))


def _side_links(u: Unitig, side: str):
    return [(t, ts) for s, t, ts in u.links if s == side]


def find_simple_bubbles(unitigs: list[Unitig], k: int,
                        max_branch_len: int | None = None) -> list[int]:
    """Simple-bubble detection on the bidirected unitig graph.

    A bubble is a source end with exactly two out-links to two distinct
    *interior* unitigs (one in-link on the entry side, one out-link on the
    exit side) that converge on the same oriented sink — the pattern a
    heterozygous SNP or a sequencing-error bulge leaves in the dBG.  The
    lower-mean-abundance branch is reported for removal (minia's
    coverage-ranked simplification for its "contigs" output; the reference
    consumes those contigs per Contig.cpp:43-117).  Only short branches
    pop (default < 3k bp) so genuine repeats survive."""
    if max_branch_len is None:
        max_branch_len = 3 * k
    drop: set[int] = set()

    def interior_exit(t: int, ts: str):
        """If unitig t entered with orientation ts is interior, return its
        oriented exit target; else None."""
        u = unitigs[t]
        entry_side = "-" if ts == "+" else "+"
        exit_side = ts
        ins = _side_links(u, entry_side)
        outs = _side_links(u, exit_side)
        if len(ins) != 1 or len(outs) != 1:
            return None
        return outs[0]

    for x in unitigs:
        for side in ("+", "-"):
            outs = _side_links(x, side)
            if len(outs) != 2:
                continue
            (t1, s1), (t2, s2) = outs
            if t1 == t2 or x.uid in (t1, t2):
                continue
            if t1 in drop or t2 in drop:
                continue
            u1, u2 = unitigs[t1], unitigs[t2]
            if (len(u1.seq) > max_branch_len
                    or len(u2.seq) > max_branch_len):
                continue
            e1 = interior_exit(t1, s1)
            e2 = interior_exit(t2, s2)
            if e1 is None or e2 is None or e1 != e2:
                continue
            if e1[0] in (t1, t2, x.uid):
                continue  # degenerate loop
            # drop the weaker branch; tie -> higher uid (deterministic)
            if (u1.km, -u1.uid) < (u2.km, -u2.uid):
                drop.add(t1)
            else:
                drop.add(t2)
    return sorted(drop)


def _kmer_ints(seq: str, k: int):
    from haslr_tpu_torch.core import seq as cseq

    codes = cseq.encode(seq)
    v = 0
    for c in codes[:k]:
        v = (v << 2) | int(c)
    yield v
    mask = (1 << (2 * k)) - 1
    for c in codes[k:]:
        v = ((v << 2) | int(c)) & mask
        yield v


def pop_bubbles(hi, lo, cnt, k: int, native: bool = True,
                max_rounds: int = 8):
    """Iteratively remove simple-bubble branches from the solid k-mer set
    and re-compact, until the unitig graph is bubble-free (or max_rounds).
    Returns the simplified unitig list.

    The whole loop (compact -> detect -> delete k-mers -> re-compact)
    runs in native code when available: the Python fallback keeps every
    solid k-mer in a dict and rebuilds it each round, which at CHM1 scale
    (~10^9 solid k-mers) costs 100+ GB of host RAM; the native path is
    bounded at ~42 bytes per k-mer in flat arrays (byte-identical
    output, asserted by tests)."""
    if native and k <= 64:
        from haslr_tpu_torch import native as hx_native

        out = hx_native.dbg_unitigs(hi, lo, cnt, k, pop_rounds=max_rounds)
        if out is not None:
            return _unitigs_from_native(out)
    counts = {}
    for h, l, c in zip(hi.tolist(), lo.tolist(), cnt.tolist()):
        counts[(int(h) << 64) | int(l)] = int(c)

    def rebuild():
        n = len(counts)
        keys = sorted(counts)
        h = np.array([v >> 64 for v in keys], np.uint64)
        l = np.array([v & ((1 << 64) - 1) for v in keys], np.uint64)
        c = np.array([counts[v] for v in keys], np.int64)
        return unitigs_from_counts(h, l, c, k, native=native), n

    unitigs, _ = rebuild()
    for _ in range(max_rounds):
        doomed = find_simple_bubbles(unitigs, k)
        if not doomed:
            break
        for uid in doomed:
            for v in _kmer_ints(unitigs[uid].seq, k):
                r = rc_int(v, k)
                counts.pop(min(v, r), None)
        unitigs, _ = rebuild()
    return unitigs


def write_unitigs_fasta(unitigs: list[Unitig], path: str):
    """Minia-format FASTA: ``>id LN:i: KC:i: km:f: L:...`` headers."""
    with open(path, "w") as fp:
        for u in unitigs:
            km = u.kc / max(1, u.kc_positions)
            links = " ".join(f"L:{a}:{b}:{c}" for a, b, c in u.links)
            header = (
                f">{u.uid} LN:i:{len(u.seq)} KC:i:{u.kc} km:f:{km:.1f}"
            )
            if links:
                header += " " + links
            fp.write(header + "\n" + u.seq + "\n")


def assemble_unitigs(codes_with_seps: np.ndarray, k: int, min_abundance: int,
                     device: bool = True, native: bool = True) -> list[Unitig]:
    """Count solid k-mers and compact to unitigs.

    Compaction runs in the native C++ walker (same algorithm and iteration
    order as the Python implementation, byte-identical outputs) when the
    library is available; ``native=False`` forces the Python path.

    Not available in the port yet: the counters it calls
    (``haslr_tpu/kernels/kmer.py``) are ROADMAP A7.  The short-read stage
    counts with the native library (``sr/assemble_sr.py``) and compacts
    with :func:`unitigs_from_counts` / :func:`pop_bubbles`."""
    raise RuntimeError(
        "assemble_unitigs needs the device / numpy k-mer counters, which "
        "are not ported yet (ROADMAP A7); count with the native library "
        "(haslr_tpu_torch.native.count_kmers_native) and call "
        "unitigs_from_counts"
    )


def _unitigs_from_native(out) -> list[Unitig]:
    seqs, kc, nk, links = out
    unitigs = [
        Unitig(i, seqs[i], int(kc[i]), 0, 0, [], int(nk[i]))
        for i in range(len(seqs))
    ]
    for fu, fs, tu, ts in links:
        unitigs[fu].links.append(
            ("+" if fs == 0 else "-", int(tu), "+" if ts == 0 else "-")
        )
    return unitigs


def unitigs_from_counts(hi, lo, cnt, k: int,
                        native: bool = True) -> list[Unitig]:
    """Compact a solid-k-mer count table to unitigs (native C++ walker when
    available, Python fallback otherwise)."""
    if native and k <= 64:
        from haslr_tpu_torch import native as hx_native

        out = hx_native.dbg_unitigs(hi, lo, cnt, k)
        if out is not None:
            return _unitigs_from_native(out)
    g = DeBruijnGraph.from_pairs(hi, lo, cnt, k)
    return g.build_unitigs()
