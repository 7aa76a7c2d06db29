"""The yeast shape on the CPU: many short linear replicons, only the short
repeat families (solo LTRs of 334 bp, tRNA genes of 80 bp) and nanopore
reads of up to 100 kb at 10 % error, generated by the benchmark's
generator from the ``yeast_nanopore`` configuration cut to three
replicons.  The port's ``run_assembler`` writes the same
``asm.final.fa`` and ``.ann`` bytes as ``haslr_tpu``'s, and the
benchmark's judge finds the assembly correct under the
``yeast_nanopore.assemble`` cell's limits.  Traced, the consensus step's
spans tile it, and its counters equal counts made from its
``log_consensus.txt``, the reads and the engine's warnings."""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from benchmark import gen, run
from benchmark.reference import assembly
from haslr_tpu_torch import trace

SEED = 2**31 + 18
# three short replicons and the configuration's short families, at
# copy numbers that put several copies on each replicon
REPLICONS = [110_000, 85_000, 65_000]
COPIES = {334: (6, 2), 80: (6, 2)}


def _config():
    cfg = run.load_json(run.BENCH, "configs", "yeast_nanopore.json")
    g, lr = cfg["genome"], cfg["long_reads"]
    g["replicons"] = REPLICONS
    g["families"] = [[*COPIES[L], L] for _n, _c, L in g["families"]
                     if L in COPIES]
    lr["genome_size"] = sum(REPLICONS)
    return cfg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def yeast(tmp_path_factory):
    torch.set_num_threads(1)
    cfg = _config()
    d = tmp_path_factory.mktemp("yeast")
    ds = gen.make_dataset(cfg, SEED, str(d / "data"))
    gen.write_true_paf(ds, ds.path("map.paf"))
    return cfg, ds, d


def _inputs(ds):
    return ds.path("contigs.fa"), ds.path("lr.fa"), ds.path("map.paf")


def _cfg(pkg, cfg):
    return pkg.AssembleConfig(
        min_aln_block=cfg["aln_block"], min_aln_sim=cfg["aln_sim"],
        min_edge_sup=cfg["edge_sup"], num_threads=1)


@pytest.fixture(scope="module")
def port_out(yeast):
    from haslr_tpu_torch import config
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    cfg, ds, d = yeast
    out = str(d / "port")
    run_assembler(*_inputs(ds), out, cfg=_cfg(config, cfg), log=None,
                  device="cpu")
    return out


@pytest.fixture(scope="module")
def traced(yeast):
    """A traced run of the port, its root and its warnings."""
    from haslr_tpu_torch import config
    from haslr_tpu_torch.assemble.pipeline import run_assembler

    cfg, ds, d = yeast
    out = str(d / "traced")
    trace.reset()
    err = io.StringIO()
    with trace.recording(), contextlib.redirect_stderr(err):
        run_assembler(*_inputs(ds), out, cfg=_cfg(config, cfg), log=None,
                      device="cpu")
    (root,) = trace.roots("asm.run")
    return root, out, err.getvalue()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_port_assembles_the_yeast_shape_as_the_reference(yeast, port_out):
    from haslr_tpu import config
    from haslr_tpu.assemble.pipeline import run_assembler

    cfg, ds, d = yeast
    out = str(d / "reference")
    run_assembler(*_inputs(ds), out, cfg=_cfg(config, cfg), log=None)
    for name in ("asm.final.fa", "asm.final.ann"):
        assert _read(f"{port_out}/{name}") == _read(f"{out}/{name}"), name
    assert len(_read(f"{out}/asm.final.fa")) > 0


def test_judge_finds_the_port_correct_under_the_cells_limits(yeast,
                                                              port_out):
    _cfg_, ds, _d = yeast
    limits = run.load_json(run.BENCH, "limits",
                           "yeast_nanopore.assemble.json")
    checks = assembly.judge(f"{port_out}/asm.final.fa", ds.genome)
    checks["passes_differ"] = 0
    correct, compared = run.judge(checks, limits)
    assert correct, compared
    assert checks["contigs"] == len(REPLICONS)


def test_traced_run_writes_the_untraced_bytes(port_out, traced):
    for name in ("asm.final.fa", "asm.final.ann", "log_consensus.txt"):
        assert _read(f"{traced[1]}/{name}") == _read(f"{port_out}/{name}")


def test_consensus_spans_tile_the_step(traced):
    root = traced[0]
    spans = trace.spans_of(root)
    (step,) = [s for s in spans if s.name == "asm.step.consensus"]
    kids = [s for s in spans if s.parent == step.id]
    assert {s.name for s in kids} == {
        "consensus.edges", "consensus.windows", "consensus.encode",
        "consensus.plan", "consensus.pack", "consensus.dispatch",
        "consensus.wait", "consensus.unpack", "consensus.decode",
        "consensus.log"}
    covered = sum(s.end_ns - s.start_ns for s in kids)
    assert 0.95 * (step.end_ns - step.start_ns) <= covered \
        <= step.end_ns - step.start_ns


def _consensus_records(path):
    """(read id, subsequence) of each supporting read of each window in
    ``log_consensus.txt``."""
    out, head = [], None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if head is not None:
                out.append((int(head.split()[0]), line))
                head = None
            elif line.startswith(">") and line != ">CONSENSUS":
                head = line[1:]
    return out


def _read_lengths(path):
    lens, name = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = int(line[1:].split()[0])
            else:
                lens[name] = lens.get(name, 0) + len(line.rstrip("\n"))
    return lens


def test_extraction_counters_equal_the_consensus_log(yeast, traced):
    _cfg_, ds, _d = yeast
    root, out, _err = traced
    recs = _consensus_records(f"{out}/log_consensus.txt")
    lens = _read_lengths(ds.path("lr.fa"))
    counts = trace.counters_of(root)
    assert counts["consensus.extract.kept"] == \
        sum(len(sub) for _rid, sub in recs) > 0
    assert counts["consensus.extract.bases"] == \
        sum(lens[rid] for rid, _sub in recs)
    assert counts["consensus.extract.bases"] > \
        counts["consensus.extract.kept"]


def test_dropped_counter_equals_the_engines_warnings(traced):
    root, _out, err = traced
    said = [int(n) for n in re.findall(
        r"consensus: ([0-9]+) band-incompatible supporting read", err)]
    assert trace.counters_of(root)["consensus.n_dropped"] == sum(said)


def test_dropped_counter_counts_band_incompatible_and_long_reads():
    """Windows of five noisy copies of a 300 bp draft, one read 100 bp
    longer (out of the band of W 128) and one longer than the S 512
    bucket: the engine skips two reads a window, warns so, and counts
    them."""
    from haslr_tpu_torch.kernels.consensus import batched_consensus

    rng = np.random.default_rng(18)
    bases = np.array(list("ACGT"))
    windows = []
    for _ in range(3):
        draft = rng.integers(0, 4, 300)
        reads = []
        for _ in range(5):
            r = draft.copy()
            r[rng.integers(0, 300, 6)] = rng.integers(0, 4, 6)
            reads.append("".join(bases[r]))
        reads.append("".join(bases[rng.integers(0, 4, 400)]))
        reads.append("".join(bases[rng.integers(0, 4, 2000)]))
        windows.append(reads)
    said = []
    with trace.recording(), trace.span("root") as root:
        batched_consensus(windows, warn=said.append, device="cpu")
    n = [int(m) for w in said for m in re.findall(
        r"([0-9]+) band-incompatible supporting read", w)]
    assert trace.counters_of(root)["consensus.n_dropped"] == sum(n) == 6


def test_the_cut_is_the_yeast_shape():
    """Three replicons of 60-120 kb, only 80 and 334 bp copies, nanopore
    lengths at 10 % error: the configuration's reads, cut in length
    only."""
    cfg = _config()
    full = run.load_json(run.BENCH, "configs", "yeast_nanopore.json")
    assert all(60_000 <= x <= 120_000 for x in cfg["genome"]["replicons"])
    assert sorted({f[2] for f in cfg["genome"]["families"]}) == [80, 334]
    assert {k: v for k, v in cfg["long_reads"].items()
            if k != "genome_size"} == \
        {k: v for k, v in full["long_reads"].items() if k != "genome_size"}
    assert json.dumps(cfg["short_reads"]) == json.dumps(full["short_reads"])
    assert np.isclose(cfg["long_reads"]["error_rate"], 0.1)
