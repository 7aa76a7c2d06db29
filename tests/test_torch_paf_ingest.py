"""The assembler's PAF ingest: ``load_alignments`` through the native scan
(``native/paf_read.cpp``) gives what its Python path and the reference's
``load_alignments`` give, record for record, on simulated PAFs and on
edits of them (gzip, blank lines, tags, CIGAR ops, filtered records, a
FOFN of shards); a file the scan does not take goes the Python way,
which reads it or raises as it always has."""

import gzip

import numpy as np
import pytest

from haslr_tpu.assemble import longread_store as ref_ls
from haslr_tpu.assemble.contig_store import ContigStore as RefContigStore
from haslr_tpu.config import AssembleConfig as RefAssembleConfig
from haslr_tpu_torch import native, trace
from haslr_tpu_torch.assemble import longread_store as ls
from haslr_tpu_torch.assemble.contig_store import ContigStore
from haslr_tpu_torch.config import AssembleConfig
from haslr_tpu_torch.testutil import simulate


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    out = tmp_path_factory.mktemp("paf_ingest")
    _g, _c, _r, (contigs, lr, paf) = simulate.simulate(
        str(out), genome_len=20_000, seed=5, coverage=12.0, error_rate=0.05
    )
    with open(paf) as f:
        lines = f.read().splitlines()
    return contigs, lr, lines


def _runs(lines):
    """(start, end) of each query's run of consecutive lines."""
    out, s = [], 0
    for i in range(1, len(lines) + 1):
        if i == len(lines) or lines[i].split("\t")[0] != \
                lines[s].split("\t")[0]:
            out.append((s, i))
            s = i
    return out


def _set(line, col, value):
    f = line.split("\t")
    f[col] = str(value)
    return "\t".join(f)


def _cigar(line):
    return [c for c in line.split("\t") if c.startswith("cg:Z:")][-1][5:]


def _with_cigar(line, cigar):
    f = [c for c in line.split("\t") if not c.startswith("cg:Z:")]
    return "\t".join(f + ["cg:Z:" + cigar])


def _blank_lines(lines):
    out = ["", "  "]
    for i, line in enumerate(lines):
        out.append(line)
        if i % 7 == 3:
            out.append(["", " \t", "\x0b\x0c ", "\x1c"][i % 4])
    return out + ["", ""]


def _no_cg(lines):
    out = list(lines)
    s, e = _runs(lines)[1]
    out[s] = "\t".join(c for c in out[s].split("\t")
                       if not c.startswith("cg:"))
    out[s + 1] = out[s + 1] + "\tcg:Z:"               # empty: not a tag
    out[e - 1] = out[e - 1] + "\tcg:Z:77M3I20M"       # the last tag wins
    return out


def _cigar_ops(lines):
    out = list(lines)
    for k, i in enumerate(range(0, len(out), 3)):
        c = _cigar(out[i])
        edits = [
            "12S" + c + "5S",
            c.replace("1I", "3=2X1I", 2),
            "5H0007M" + c + "0M4N12",
            c.replace("M", "=", 3) + "x9",
        ]
        out[i] = _with_cigar(out[i], edits[k % 4])
    return out


def _middle_fail(lines):
    out = list(lines)
    long_runs = [r for r in _runs(lines) if r[1] - r[0] >= 3]
    for k, (s, e) in enumerate(long_runs[:6]):
        m = (s + e) // 2
        if k % 3 == 0:
            out[m] = _set(out[m], 11, 0)                  # filter 3: mapq
        elif k % 3 == 1:
            out[m] = _set(_set(out[m], 10, 40), 9, 39)    # filter 1: block
        else:
            out[m] = _set(out[m], 9, 1)                   # filter 2: sim
    return out


def _interleaved(lines):
    """Another read's failing record between two records of one read,
    and one that passes: the groups split where the Python loop splits
    them."""
    out = list(lines)
    runs = [r for r in _runs(lines) if r[1] - r[0] >= 2]
    (s0, _e0), (s1, _e1), (s2, _e2) = runs[:3]
    out.insert(s1 + 1, _set(lines[s0], 11, 0))
    out.insert(s2 + 2, lines[s0])
    return out


def _gzip(path, lines):
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


def _crlf(path, lines):
    with open(path, "w", newline="") as f:
        f.write("".join(line + "\r\n" for line in lines))


def _first_passing(lines):
    return _runs(lines)[2][0]


def _leading_zero_name(lines):
    out = list(lines)
    i = _first_passing(lines)
    out[i] = _set(out[i], 0, "0" + out[i].split("\t")[0])
    return out


def _non_integer_name(lines):
    out = list(lines)
    i = _first_passing(lines)
    out[i] = _set(out[i], 0, "read" + out[i].split("\t")[0])
    return out


def _target_past_contigs(lines):
    out = list(lines)
    i = _first_passing(lines)
    out[i] = _set(out[i], 5, 10**6)
    return out


def _zero_block(lines):
    out = list(lines)
    out[3] = _set(_set(out[3], 10, 0), 9, 0)
    return out


# name: (edit of the lines, writer, shards, uniq_freq scale, min_aln_block,
#        the native scan takes the file, the exception all three raise)
CASES = {
    "plain": (None, None, 1, 1.0, None, True, None),
    "gzip": (None, _gzip, 1, 1.0, None, True, None),
    "blank_lines": (_blank_lines, None, 1, 1.0, None, True, None),
    "no_cg": (_no_cg, None, 1, 1.0, None, True, None),
    "cigar_ops": (_cigar_ops, None, 1, 1.0, None, True, None),
    "middle_fail": (_middle_fail, None, 1, 1.0, None, True, None),
    "interleaved": (_interleaved, None, 1, 1.0, None, True, None),
    "high_copy": (None, None, 1, 0.3, None, True, None),
    "fofn_two_shards": (_middle_fail, None, 2, 1.0, None, True, None),
    "crlf": (None, _crlf, 1, 1.0, None, False, None),
    "leading_zero_name": (_leading_zero_name, None, 1, 1.0, None, False,
                          None),
    "non_integer_name": (_non_integer_name, None, 1, 1.0, None, False,
                         ValueError),
    "target_past_contigs": (_target_past_contigs, None, 1, 1.0, None, False,
                            IndexError),
    "zero_block": (_zero_block, None, 1, 1.0, 0, False, ZeroDivisionError),
}


def _write(tmp_path, lines, writer, shards):
    paths = []
    runs = _runs(lines)
    cut = runs[len(runs) // 2][0] if shards == 2 else len(lines)
    for k, part in enumerate([lines[:cut], lines[cut:]][:shards]):
        p = str(tmp_path / f"map{k}.paf{'.gz' if writer is _gzip else ''}")
        if writer is None:
            with open(p, "w") as f:
                f.write("\n".join(part) + "\n")
        else:
            writer(p, part)
        paths.append(p)
    return paths


def _rows(alignments):
    return [
        [tuple((v.dtype.str, v.tobytes()) if isinstance(v, np.ndarray)
               else (type(v).__name__, v) for v in vars(a).values())
         for a in per_read]
        for per_read in alignments
    ]


def _load(mod, store_cls, cfg, contigs_path, lr, paths, scale, raises):
    """(return value, per-read rows, counters) of loading every shard;
    None where it raises ``raises``, as it must then."""
    contigs = store_cls.load_fasta(contigs_path)
    uniq = contigs.calc_uniq_freq() * scale
    lrs = mod.LongreadStore.load_fasta(lr)
    with trace.recording(), trace.span("root") as root:
        if raises is not None:
            with pytest.raises(raises):
                for p in paths:
                    mod.load_alignments(p, contigs, lrs, uniq, cfg)
            return None
        n = sum(mod.load_alignments(p, contigs, lrs, uniq, cfg)
                for p in paths)
    return n, _rows(lrs.alignments), trace.counters_of(root)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_ingest_equals_python_and_reference(sim, tmp_path,
                                                   monkeypatch, case):
    edit, writer, shards, scale, min_block, takes, raises = CASES[case]
    contigs_path, lr, lines = sim
    paths = _write(tmp_path, edit(lines) if edit else lines, writer, shards)
    kw = {} if min_block is None else {"min_aln_block": min_block}
    args = (contigs_path, lr, paths, scale, raises)
    assert native.get_lib() is not None
    got = _load(ls, ContigStore, AssembleConfig(**kw), *args)
    ref = _load(ref_ls, RefContigStore, RefAssembleConfig(**kw), *args)
    with monkeypatch.context() as m:
        m.setattr(native, "paf_read_native", lambda *a: None)
        py = _load(ls, ContigStore, AssembleConfig(**kw), *args)
    if raises is not None:
        return
    n, rows, counts = got
    assert n > 0
    assert (n, rows) == py[:2] == ref[:2]
    assert counts["asm.paf.native"] == (counts["asm.paf.records"]
                                        if takes else 0)
    assert py[2]["asm.paf.native"] == 0
    assert {k: v for k, v in counts.items() if k != "asm.paf.native"} == \
        {k: v for k, v in py[2].items() if k != "asm.paf.native"}


def test_native_cigar_decode_matches_the_regex(tmp_path):
    """``paf_read_native``'s decode == ``core.cigar.parse`` on CIGARs of
    every kind of byte the regex skips or takes, zero-padded and long
    lengths among them; a length past int64 refuses the file."""
    from haslr_tpu_torch.core import cigar as ccigar

    rng = np.random.default_rng(3)
    alphabet = list("MIDMIDMID=XSHNP*#0123456789") + ["007", "0000", "12"]
    cigars = ["", "M", "5", "12M", "0M", "999999999999999999M",
              "0000000000000000000000012I", "3M2", "x9D", "1M1M"]
    cigars += ["".join(rng.choice(alphabet, size=rng.integers(1, 40)))
               for _ in range(300)]
    p = str(tmp_path / "c.paf")
    with open(p, "w") as f:
        for i, c in enumerate(cigars):
            f.write(f"{i}\t100\t0\t90\t+\t{i % 5}\t80\t0\t80\t70\t90\t60"
                    f"\ttp:A:P\tcg:Z:{c}\n")
    cols, rows, ops, lens, off = native.paf_read_native(
        p, lambda cols: np.arange(len(cols))[::-1])
    assert cols.shape == (len(cigars), native.PAF_COLS)
    for k, r in enumerate(rows):
        want_ops, want_lens = ccigar.parse(cigars[r])
        assert ops[off[k]:off[k + 1]].tobytes() == want_ops.tobytes()
        assert lens[off[k]:off[k + 1]].tobytes() == want_lens.tobytes()
    with open(p, "a") as f:
        f.write("7\t100\t0\t90\t+\t0\t80\t0\t80\t70\t90\t60"
                "\tcg:Z:10000000000000000000M\n")
    assert native.paf_read_native(p, lambda cols: np.arange(len(cols))) \
        is None
    assert native.paf_read_native(p, lambda cols: np.arange(len(cols) - 1)) \
        is not None
