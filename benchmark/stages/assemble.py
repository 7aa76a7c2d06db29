"""The ``haslr_assemble`` stage: ``haslr_tpu_torch.assemble.pipeline.
run_assembler`` over the whole long-read set, every short-read contig and
the reads' true PAF against the contigs of at least ``min_src`` bases
(what the pipeline's mapping stage aligns to).

A pass loads the inputs, builds and cleans the backbone graph on the
host, calls the consensus of every edge's window on the card (B1 and V1
under the dense engine) and writes the assembly.  The aligner is
bypassed: the mapping is the generator's."""

from __future__ import annotations

import contextlib
import os

from benchmark import gen, readers
from benchmark.probes import patched
from benchmark.reference import assembly

RATE = "asm_mbp_per_s"
OUTPUTS = ("asm.final.fa",)
_P = "haslr_tpu_torch.assemble.pipeline"
SPANS = (
    (_P, "_load_inputs", "asm.load"),
    (_P, "fix_alignments", "asm.fix"),
    (_P, "build_compact_longreads", "asm.compact"),
    ("haslr_tpu_torch.assemble.backbone", "build_graph", "asm.graph"),
    (_P, "_clean", "asm.clean"),
    (_P, "calc_edge_coordinates", "asm.coordinates"),
    (_P, "calc_consensus", "asm.consensus"),
    (_P, "get_assembly", "asm.stitch"),
)


class State:
    def __init__(self, cfg, traffic, ds):
        self.cfg, self.traffic, self.ds = cfg, traffic, ds


def prepare(cfg, traffic, seed, work) -> State:
    ds = gen.make_dataset(cfg, seed, os.path.join(work, "data"))
    gen.write_true_paf(ds, ds.path("map.paf"))
    n = max(1, int(len(ds.reads) * traffic["warmup_share"]))
    gen.write_reads(ds.path("lr.warm.fa"), ds.reads, range(n))
    gen.write_true_paf(ds, ds.path("map.warm.paf"), n_reads=n)
    return State(cfg, traffic, ds)


def pass_mbp(st: State) -> float:
    return st.ds.reads.n_bases / 1e6


def run_pass(st: State, out_dir: str, device, warm: bool = False) -> dict:
    """One ``run_assembler`` call into ``out_dir``; returns its stage
    seconds (its ``StageTimer`` log) and the dense engine's ``PROF``."""
    from haslr_tpu_torch.assemble import pipeline
    from haslr_tpu_torch.config import AssembleConfig
    from haslr_tpu_torch.kernels import consensus_dense

    c = st.cfg
    cfg = AssembleConfig(min_aln_block=c["aln_block"],
                         min_aln_sim=c["aln_sim"], min_edge_sup=c["edge_sup"],
                         num_threads=c["threads"])
    ds = st.ds
    consensus_dense.PROF.clear()
    log_path = os.path.join(out_dir, "asm.log")
    os.makedirs(out_dir, exist_ok=True)
    with open(log_path, "w") as log:
        pipeline.run_assembler(
            ds.path("contigs.fa"),
            ds.path("lr.warm.fa" if warm else "lr.fa"),
            ds.path("map.warm.paf" if warm else "map.paf"), out_dir,
            cfg=cfg, log=log, device=device)
    with open(log_path) as f:
        stages = readers.stage_seconds(f.read())
    return {"stages": stages, "consensus": dict(consensus_dense.PROF)}


def check(st: State, out_dir: str, rng, device) -> dict:
    return assembly.judge(os.path.join(out_dir, "asm.final.fa"),
                          st.ds.genome)


def _consensus_plant(change):
    """``batched_consensus`` with its answers passed through
    ``change(windows, answers)``."""
    def make(orig):
        def consensus(windows, *a, **kw):
            return change(windows, orig(windows, *a, **kw))
        return consensus
    return patched("haslr_tpu_torch.kernels.consensus", "batched_consensus",
                   make)


def _raw(windows, answers):
    """No consensus: each window's first supporting read as it is."""
    return [next((s for s in w if s), a) for w, a in zip(windows, answers)]


def _half(windows, answers):
    """Half of the batch left out: the odd windows get no answer."""
    return [a if i % 2 == 0 else "" for i, a in enumerate(answers)]


def _alter(windows, answers):
    """Answers altered where they are produced: every 20th base of each
    window's consensus changed.  (One base a window, ~0.0006 of the
    assembly's 31-mers in E. coli, lies inside the sound runs' spread of
    false 31-mers and cannot be told from them by this check.)"""
    swap = str.maketrans("ACGT", "CGTA")
    out = []
    for a in answers:
        out.append("".join(c.translate(swap) if i % 20 == 10 else c
                           for i, c in enumerate(a)))
    return out


def _break_joins(orig):
    """A fault of the graph stack: once the weak edges are gone, every
    third edge of the backbone graph (with its twin) goes too, as if
    its support had been lost."""
    def remove_weak_edges(graph, min_edge_sup):
        from haslr_tpu_torch.assemble import backbone as bb

        removed = orig(graph, min_edge_sup)
        lost = list(bb.unique_edges(graph))[::3]
        for n1, r1, n2, r2, _edge, _twin in lost:
            bb.remove_edge(graph, n1, r1, n2, r2)
        return removed + len(lost)
    return remove_weak_edges


PLANTS = {
    "control": lambda st: _consensus_plant(_raw),
    "half": lambda st: _consensus_plant(_half),
    "alter": lambda st: _consensus_plant(_alter),
    "graph": lambda st: patched("haslr_tpu_torch.assemble.backbone",
                                "remove_weak_edges", _break_joins),
}
