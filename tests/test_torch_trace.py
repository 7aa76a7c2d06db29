"""The port's trace (``haslr_tpu_torch.trace``): off, it records nothing
and opens no profiler range; on, its spans nest, tile ``run_assembler``
(``asm.step.*``), lie on the profiler's clock, and its counters equal
counts made from the inputs; the benchmark's readers of it read a
hand-built record; the CLIs' ``--trace FILE`` writes it out."""

import gzip
import json
import os
import re

import numpy as np
import pytest
import torch

from haslr_tpu_torch import trace
from haslr_tpu_torch.config import AssembleConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "input")
STEPS = ["contigs", "uniq_freq", "reads", "alignments", "fix", "compact",
         "graph", "weak_edges", "tips", "simple_bubbles", "super_bubbles",
         "small_bubbles", "coordinates", "consensus", "stitch"]


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(1)
    trace.reset()


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _range_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_off_records_nothing_and_opens_no_range():
    assert not trace.on()
    with trace.span("off.root"):
        with trace.span("off.child"):
            trace.count("off.n", 3)
            with trace.launch("k", 4, 8, 32, torch.ones(4)):
                pass
    assert trace.roots() == []
    with _profile() as prof:
        torch.ones(8).sum()
    assert not any(n.startswith("off.") for n in _range_names(prof))


def test_spans_nest_with_roots_and_self_time():
    with trace.recording():
        assert trace.on()
        with trace.span("root") as root:
            with trace.span("a") as a:
                with trace.span("a1") as a1:
                    trace.count("n", 2)
                trace.count("n", torch.tensor(5))
            with trace.span("b") as b:
                pass
        with trace.span("second"):
            pass
    assert not trace.on()
    assert [r.name for r in trace.roots()] == ["root", "second"]
    assert trace.roots("root") == [root]
    assert [s.name for s in trace.spans_of(root)] == ["root", "a", "a1", "b"]
    assert (root.parent, a.parent, a1.parent, b.parent) == \
        (None, root.id, a.id, root.id)
    assert all(s.root is root for s in (a, a1, b))
    assert trace.counters_of(root) == {"n": 7}
    for s in (root, a, a1, b):
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0
    assert root.start_ns <= a.start_ns <= a1.start_ns <= a1.end_ns \
        <= a.end_ns <= b.start_ns <= b.end_ns <= root.end_ns
    # self time: the duration less what the children cover
    a.start_ns, a.end_ns, a1.start_ns, a1.end_ns = 100, 200, 120, 150
    root.start_ns, root.end_ns, b.start_ns, b.end_ns = 0, 1000, 180, 400
    assert trace.self_ns(a1) == 30
    assert trace.self_ns(a) == 70
    assert trace.self_ns(root) == 1000 - 300  # 180-200 counted once


def test_launch_records_cells_on_the_open_root():
    r_lens = torch.tensor([10, 300, 0, 256], dtype=torch.int32)
    with trace.recording(), trace.span("root") as root:
        with trace.launch("rowscan_votes", 4, 256, 128, r_lens):
            pass
        with trace.launch("vote_tables", 4, windows=2, S=512):
            pass
    votes, v1 = trace.launches_of(root)
    assert (votes.kernel, votes.rows, votes.width, votes.band) == \
        ("rowscan_votes", 4, 256, 128)
    assert int(votes.cells) == (10 + 256 + 0 + 256) * 128
    assert (v1.kernel, v1.windows, v1.S, v1.cells) == \
        ("vote_tables", 2, 512, None)
    assert trace.device_ms(votes) is None  # no stream: no events


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_golden")
    paths = []
    for name in ("contigs.fa", "lr.fa", "map.paf"):
        with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as fi, \
                open(d / name, "wb") as fo:
            fo.write(fi.read())
        paths.append(str(d / name))
    return d, paths


def _assemble(golden, name, engine="tpu"):
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    d, paths = golden
    out = str(d / name)
    with open(out + ".log", "w") as log:
        stats = run_assembler(*paths, out,
                              cfg=AssembleConfig(consensus_engine=engine),
                              log=log, device="cpu")
    with open(out + ".log") as f:
        return stats, f.read()


@pytest.fixture(scope="module")
def traced(golden):
    trace.reset()
    with trace.recording():
        stats, log = _assemble(golden, "traced")
    (root,) = trace.roots("asm.run")
    return root, stats, log


def test_steps_tile_the_run(traced):
    root = traced[0]
    spans = trace.spans_of(root)
    steps = [s for s in spans if s.name.startswith("asm.step.")]
    assert [s.name for s in steps] == ["asm.step." + n for n in STEPS]
    assert all(s.parent == root.id for s in steps)
    covered = sum(s.end_ns - s.start_ns for s in steps)
    assert covered <= root.end_ns - root.start_ns
    assert covered >= 0.99 * (root.end_ns - root.start_ns)
    names = {s.name for s in spans}
    assert {"asm.parse.contigs", "asm.parse.reads", "asm.parse.paf",
            "asm.snapshot.contig", "asm.snapshot.longread",
            "consensus.windows", "consensus.pack", "consensus.dispatch",
            "consensus.wait", "consensus.unpack"} <= names
    counts = trace.counters_of(root)
    assert counts["consensus.n_groups"] >= 1
    assert counts["consensus.n_windows"] >= counts["consensus.n_groups"]
    assert counts["consensus.n_reads"] >= counts["consensus.n_windows"]


def test_snapshot_bytes_are_the_index_files(golden, traced):
    """A fresh run counts the bytes of the two snapshots it wrote."""
    d, _paths = golden
    sizes = sum(os.path.getsize(d / "traced" / f"index.{kind}.npz")
                for kind in ("contig", "longread"))
    assert trace.counters_of(traced[0])["asm.snapshot.bytes"] == sizes > 0


def test_traced_log_has_the_untraced_lines(golden, traced):
    _stats, log = _assemble(golden, "untraced")

    def lines(text):
        return re.sub(r"[0-9]+\.[0-9]{2}", "S", text).splitlines()

    assert lines(traced[2]) == lines(log)
    assert log.count("[NOTE]") == len(STEPS)


def test_paf_counters_equal_counts_of_the_file(golden, traced):
    """Lines, lines past filters 1-4 (each parses its CIGAR) and the
    alignments the run reports kept."""
    from haslr_tpu_torch.assemble.contig_store import ContigStore

    root, stats, _log = traced
    cfg = AssembleConfig()
    _d, (contigs, _lr, paf) = golden
    mean_kmer = ContigStore.load_fasta(contigs).mean_kmer
    records = cigars = 0
    with open(paf) as f:
        for line in f:
            if not line.strip():
                continue
            records += 1
            col = line.split("\t")
            n_match, n_block, mapq = int(col[9]), int(col[10]), int(col[11])
            if n_block >= cfg.min_aln_block \
                    and n_match / n_block >= cfg.min_aln_sim \
                    and mapq >= cfg.min_aln_mapq \
                    and mean_kmer[int(col[5])] <= \
                    stats["uniq_freq"] * (3 + cfg.max_uniq_dev):
                cigars += 1
    counts = trace.counters_of(root)
    assert counts["asm.paf.records"] == records > 0
    assert counts["asm.paf.cigars"] == cigars
    assert counts["asm.paf.kept"] == stats["n_alignments"]
    assert 0 < stats["n_alignments"] <= cigars < records


def test_spans_lie_on_the_profilers_clock(golden):
    """Each span's ``record_function`` range starts and ends within 5 ms
    of its ``time_ns`` stamps."""
    with _profile() as prof:
        _assemble(golden, "profiled", engine="poa")
    (root,) = trace.roots("asm.run")
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = trace.spans_of(root)
    assert len(spans) > len(STEPS)
    for s in spans:
        (a, b), = [r for r in ranges[s.name]
                   if abs(r[0] - s.start_ns) < 5e6]
        assert abs(b - s.end_ns) < 5e6, s.name


def _record(names_times, counters=None):
    """One ``asm.run`` root whose spans have the given (name, start s,
    end s), the first the root itself."""
    with trace.recording():
        opened = []
        with trace.span("asm.run") as root:
            for name, _a, _b in names_times[1:]:
                with trace.span(name) as s:
                    opened.append(s)
            for k, v in (counters or {}).items():
                trace.count(k, v)
    for s, (_n, a, b) in zip([root] + opened, names_times):
        s.start_ns, s.end_ns = int(a * 1e9), int(b * 1e9)
    return root


def _reader(name):
    from benchmark.run import metric_reader

    return metric_reader(name)


def test_readers_on_a_hand_built_record():
    spans = [("asm.run", 100.0, 110.0), ("asm.step.contigs", 100.0, 101.0),
             ("asm.parse.contigs", 100.0, 100.5),
             ("asm.snapshot.contig", 100.5, 100.75),
             ("asm.step.reads", 101.0, 103.0),
             ("asm.parse.reads", 101.0, 102.75),
             ("asm.step.alignments", 103.0, 106.0),
             ("asm.parse.paf", 103.0, 105.0),
             ("asm.snapshot.longread", 105.0, 105.5),
             ("asm.step.consensus", 106.5, 109.0),
             ("consensus.edges", 106.5, 106.55),
             ("consensus.windows", 106.55, 106.75),
             ("consensus.encode", 106.75, 106.8),
             ("consensus.plan", 106.8, 106.85),
             ("consensus.pack", 106.85, 106.9),
             ("consensus.dispatch", 106.9, 107.0),
             ("consensus.wait", 107.0, 107.25),
             ("consensus.unpack", 107.25, 107.5),
             ("consensus.wait", 108.0, 108.5),
             ("consensus.decode", 108.5, 108.6),
             ("consensus.log", 108.6, 108.9)]
    counts = {"asm.paf.records": 40, "asm.paf.cigars": 20,
              "asm.paf.kept": 5, "consensus.extract.bases": 800,
              "consensus.extract.kept": 200}
    # an older run that the window's passes do not hold
    _record([("asm.run", 0.0, 50.0), ("asm.parse.paf", 1.0, 40.0)])
    _record(spans, counts)
    _record([(n, a + 20, b + 20) for n, a, b in spans], counts)
    ctx = {"passes": [{}, {}],
           "events": [("k", 106.1, 106.3), ("k", 126.0, 126.5)]}
    assert _reader("asm.paf_s")(ctx) == pytest.approx(2.0)
    assert _reader("asm.fasta_s")(ctx) == pytest.approx(0.5 + 1.75)
    assert _reader("asm.snapshot_s")(ctx) == pytest.approx(0.25 + 0.5)
    assert _reader("asm.cigar_waste_pct")(ctx) == pytest.approx(75.0)
    assert _reader("consensus.wait_s")(ctx) == pytest.approx(0.75)
    # windows, encode, plan, pack, unpack, decode, log; not the edges,
    # the dispatch or the waits
    assert _reader("consensus.glue_s")(ctx) == \
        pytest.approx(0.2 + 0.05 + 0.05 + 0.05 + 0.25 + 0.1 + 0.3)
    assert _reader("consensus.extract_waste_pct")(ctx) == \
        pytest.approx(75.0)
    # idle outside every step: 106-106.5 less the kernel at 106.1-106.3,
    # and 109-110; the second pass's 126-126.5 is all busy
    assert _reader("asm.unspanned_idle_s")(ctx) == \
        pytest.approx(((0.5 - 0.2) + 1.0 + 1.0) / 2)


def test_readers_find_nothing_without_runs():
    ctx = {"passes": [{}], "events": [("k", 0.0, 1.0)]}
    for name in ("asm.paf_s", "asm.fasta_s", "asm.snapshot_s",
                 "asm.cigar_waste_pct", "consensus.wait_s",
                 "asm.unspanned_idle_s", "consensus.glue_s",
                 "consensus.extract_waste_pct"):
        assert _reader(name)(ctx) is None, name


def test_haslr_assemble_writes_its_trace(golden, tmp_path):
    from haslr_tpu_torch.cli.haslr_assemble import main

    _d, (contigs, lr, paf) = golden
    path = str(tmp_path / "trace.jsonl")
    assert main(["-c", contigs, "-l", lr, "-m", paf, "-d",
                 str(tmp_path / "out"), "--consensus-engine", "poa",
                 "--device", "cpu", "--trace", path]) == 0
    assert not trace.on()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    spans = [r for r in recs if "span" in r]
    assert spans[0]["span"] == "asm.run" and spans[0]["parent"] is None
    assert {r["span"] for r in spans} >= {"asm.step." + n for n in STEPS}
    for r in spans:
        assert r["end_ns"] >= r["start_ns"] and r["cpu_ns"] >= 0
    (counts,) = [r for r in recs if "counters" in r]
    assert counts["root"] == spans[0]["id"]
    assert counts["counters"]["asm.paf.kept"] > 0
    assert np.all([r["parent"] in {s["id"] for s in spans}
                   for r in spans[1:]])


def test_haslr_writes_a_span_a_stage(tmp_path, monkeypatch):
    """``haslr --trace FILE``: ``pipeline.run`` and one ``pipeline.<stage>``
    span a stage (the stages stubbed: their own runs are other tests')."""
    from haslr_tpu_torch.cli import haslr

    for name in ("lr.fa", "sr.fq"):
        (tmp_path / name).write_text(">r\nACGT\n")
    stages = ["prepare_lrs", "assemble_srs", "remove_short_src",
              "align_lr_src", "assemble_lr"]
    monkeypatch.setattr(haslr, "_get_mesh", lambda cfg, device, mesh: None)
    for name in stages:
        monkeypatch.setattr(haslr, name, lambda *a, _n=name: (
            ("noov.fa", "good.fa") if _n == "remove_short_src" else _n))
    path = str(tmp_path / "trace.jsonl")
    assert haslr.main(["-o", str(tmp_path / "out"), "-g", "1k", "-l",
                       str(tmp_path / "lr.fa"), "-x", "pacbio", "-s",
                       str(tmp_path / "sr.fq"), "--device", "cpu",
                       "--trace", path]) == 0
    with open(path) as f:
        spans = [json.loads(line) for line in f if '"span"' in line]
    assert [r["span"] for r in spans] == \
        ["pipeline.run"] + ["pipeline." + n for n in stages]
    assert all(r["parent"] == spans[0]["id"] for r in spans[1:])
    assert haslr.parse_options(["-o", "x", "-g", "1k", "-l",
                                str(tmp_path / "lr.fa"), "-x", "pacbio",
                                "-c", str(tmp_path / "sr.fq")])[1] == "cuda"
