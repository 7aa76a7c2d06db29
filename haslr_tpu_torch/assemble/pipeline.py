"""The core assembler pipeline with the port's consensus engine (port of
:func:`haslr_tpu.assemble.pipeline.run_assembler`).

The same 13 steps as the reference (``main.cpp:28-228``), the same stage
artifacts (``backbone.NN.*.gfa/.stat``, ``compact_uniq.txt``,
``asm.final.fa/.ann``, logs) and the same ``index.contig.npz`` /
``index.longread.npz`` snapshot resume — snapshots written by either
package load in the other.  Every step but consensus is the port's own
copy of the host code of :mod:`haslr_tpu.assemble`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from haslr_tpu_torch import trace
from haslr_tpu_torch.assemble import backbone as bb
from haslr_tpu_torch.assemble import cleaning, index_io
from haslr_tpu_torch.assemble.compact import (
    build_compact_longreads,
    write_compact_longreads,
)
from haslr_tpu_torch.assemble.consensus import calc_consensus
from haslr_tpu_torch.assemble.contig_store import ContigStore
from haslr_tpu_torch.assemble.coords import calc_edge_coordinates
from haslr_tpu_torch.assemble.longread_store import (
    LongreadStore,
    fix_alignments,
    load_alignments,
)
from haslr_tpu_torch.assemble.stitch import get_assembly
from haslr_tpu_torch.config import AssembleConfig
from haslr_tpu_torch.core.io import read_fofn
from haslr_tpu_torch.dist.mesh import as_mesh


class StageTimer:
    """Per-stage wall/CPU timing (reference get_cpu_time/get_real_time,
    Common.cpp:152-165, printed after every stage of main.cpp)."""

    def __init__(self, log=sys.stderr):
        self.t0 = time.time()
        self.c0 = time.process_time()
        self.log = log

    def note(self, msg: str):
        print(f"[NOTE] {msg}", file=self.log)

    def elapsed(self):
        print(
            f"       elapsed time {time.process_time() - self.c0:.2f} CPU"
            f" seconds ({time.time() - self.t0:.2f} real seconds)\n",
            file=self.log,
        )


@contextlib.contextmanager
def _step(t: StageTimer, name: str, note: str):
    """One ``StageTimer`` stage, ``note`` printed as it starts and the
    elapsed time as it ends, inside the span ``asm.step.<name>``."""
    with trace.span("asm.step." + name):
        t.note(note)
        yield
        t.elapsed()


def _load_inputs(contig_path, long_path, mapping_path, out_dir, cfg, t,
                 log, long_fofn, mapping_fofn):
    """Steps 1-3: contigs, their unique-k-mer frequency, long reads and
    alignments — each from its snapshot when one exists."""
    contig_idx = f"{out_dir}/index.contig.npz"
    if os.path.isfile(contig_idx):
        with _step(t, "contigs", f"reading contig index: {contig_idx}..."):
            with trace.span("asm.resume.contig"):
                contigs = index_io.read_contig_index(contig_idx)
            print(f"       loaded {len(contigs)} contigs", file=log)
    else:
        with _step(t, "contigs", "loading contig sequences..."):
            with trace.span("asm.parse.contigs"):
                contigs = ContigStore.load_fasta(contig_path)
            with trace.span("asm.snapshot.contig"):
                index_io.write_contig_index(contig_idx, contigs)
                trace.count("asm.snapshot.bytes",
                            os.path.getsize(contig_idx))
            print(f"       loaded {len(contigs)} contigs", file=log)

    with _step(t, "uniq_freq",
               "calculating kmer frequency of unique contigs"):
        uniq_freq = contigs.calc_uniq_freq()
        print(f"       mean: {uniq_freq:.2f}", file=log)

    lr_idx = f"{out_dir}/index.longread.npz"
    if os.path.isfile(lr_idx):
        with _step(t, "reads",
                   f"reading long read and alignment index: {lr_idx}..."):
            with trace.span("asm.resume.longread"):
                lrs, n_aln = index_io.read_longread_index(lr_idx)
            print(f"       loaded {len(lrs)} long reads", file=log)
            print(f"       loaded {n_aln} alignments", file=log)
        return contigs, uniq_freq, lrs, n_aln

    with _step(t, "reads", "loading long read sequences..."):
        with trace.span("asm.parse.reads"):
            if long_fofn:
                lrs = LongreadStore()
                for p in read_fofn(long_path):
                    sub = LongreadStore.load_fasta(p)
                    for i in range(len(sub)):
                        lrs.seqs.add(sub.seqs.get(i))
                        lrs.alignments.append([])
            else:
                lrs = LongreadStore.load_fasta(long_path)
        print(f"       loaded {len(lrs)} long reads", file=log)

    with _step(t, "alignments",
               "loading alignment between contigs and long reads..."):
        n_aln = 0
        with trace.span("asm.parse.paf"):
            for p in read_fofn(mapping_path) if mapping_fofn \
                    else [mapping_path]:
                n_aln += load_alignments(p, contigs, lrs, uniq_freq, cfg)
        print(f"       loaded {n_aln} alignments", file=log)
        with trace.span("asm.snapshot.longread"):
            index_io.write_longread_index(lr_idx, lrs)
            trace.count("asm.snapshot.bytes", os.path.getsize(lr_idx))
    return contigs, uniq_freq, lrs, n_aln


def _clean(graph, contigs, out_dir, cfg, t, log):
    """Steps 6-10: the cleaning cascade with its stat/GFA snapshots;
    returns the removal counts."""

    def snapshot(tag):
        bb.general_stats(graph, contigs, f"{out_dir}/backbone.{tag}.stat")
        bb.write_gfa(graph, contigs, f"{out_dir}/backbone.{tag}.gfa")

    with _step(t, "weak_edges", "cleaning weak edges..."):
        nb_weak = bb.remove_weak_edges(graph, cfg.min_edge_sup)
        print(f"       removed {nb_weak} edges", file=log)
        snapshot("02.weakEdge")

    with _step(t, "tips", "cleaning tips..."):
        nb_tips = 0
        with open(f"{out_dir}/backbone.03.tip.log", "w") as tip_log:
            for depth in cfg.tip_depths:
                nb_tips += cleaning.clean_tips(graph, depth, tip_log)
        print(f"       removed {nb_tips} tips", file=log)
        snapshot("03.tip")

    with _step(t, "simple_bubbles", "cleaning simple bubbles..."):
        with open(f"{out_dir}/backbone.04.simplebubble.log", "w") as sb_log:
            nb_simple = cleaning.clean_simple_bubbles_old(
                graph, cfg.simple_bubble_depth, sb_log
            )
        print(f"       removed {nb_simple} simple bubbles", file=log)
        snapshot("04.simplebubble")

    with _step(t, "super_bubbles", "cleaning super bubbles..."):
        with open(f"{out_dir}/backbone.05.superbubble.log", "w") as sup_log:
            nb_super = cleaning.clean_super_bubbles(
                graph, cfg.super_bubble_max_dist, sup_log
            )
        print(f"       removed {nb_super} super bubbles", file=log)
        snapshot("05.superbubble")

    with _step(t, "small_bubbles", "cleaning small bubbles..."):
        with open(f"{out_dir}/backbone.06.smallbubble.log", "w") as sm_log:
            nb_small = cleaning.clean_small_bubbles(graph, sm_log)
        print(f"       removed {nb_small} small bubbles", file=log)
        snapshot("06.smallbubble")
    return {
        "weak": nb_weak,
        "tips": nb_tips,
        "simple_bubbles": nb_simple,
        "super_bubbles": nb_super,
        "small_bubbles": nb_small,
    }


def run_assembler(
    contig_path: str,
    long_path: str,
    mapping_path: str,
    out_dir: str,
    cfg: AssembleConfig | None = None,
    log=sys.stderr,
    long_fofn: bool = False,
    mapping_fofn: bool = False,
    device: torch.device | str | None = None,
    mesh=None,
) -> dict:
    """Full assembler run with consensus on ``device`` (the card unless
    the caller says ``"cpu"``) or, given a ``dp``
    :class:`~haslr_tpu_torch.dist.mesh.Mesh`, over its devices; returns a
    stats dict (uniq_freq, edge/contig counts, output path).
    ``long_fofn``/``mapping_fofn`` read the paths as file-of-file-names
    like the reference's ``--long-fofn``/``--mapping-fofn``.  The run is
    the trace's span ``asm.run``, tiled by one ``asm.step.<stage>`` span
    a ``StageTimer`` stage."""
    with trace.span("asm.run"):
        cfg = cfg or AssembleConfig()
        if cfg.consensus_engine == "tpu":
            # the host POA engine needs no device
            mesh = as_mesh(device, mesh)
        os.makedirs(out_dir, exist_ok=True)
        t = StageTimer(log)
        contigs, uniq_freq, lrs, n_aln = _load_inputs(
            contig_path, long_path, mapping_path, out_dir, cfg, t, log,
            long_fofn, mapping_fofn,
        )

        with _step(t, "fix", "fixing overlapping alignments..."):
            fix_alignments(lrs)

        with _step(t, "compact", "building compact long reads..."):
            compact = build_compact_longreads(lrs, contigs, uniq_freq, cfg,
                                              copy_count=1)
            write_compact_longreads(compact, f"{out_dir}/compact_uniq.txt")

        with _step(t, "graph", "building the backbone graph..."):
            graph = bb.build_graph(contigs, compact, uniq_freq, cfg)
            bb.general_stats(graph, contigs,
                             f"{out_dir}/backbone.01.init.stat")
            bb.write_gfa(graph, contigs, f"{out_dir}/backbone.01.init.gfa")

        removed = _clean(graph, contigs, out_dir, cfg, t, log)

        # the branching report lies between two stages of the log, whose
        # seconds count it in the next
        with _step(t, "coordinates",
                   "calculating long read coordinates between anchors..."):
            bb.report_branching_nodes(graph,
                                      f"{out_dir}/backbone.branching.log")
            n_edges = calc_edge_coordinates(
                graph, contigs, lrs, compact,
                log_path=f"{out_dir}/log_coordinate.txt",
            )

        with _step(t, "consensus",
                   "calling consensus sequence between anchors..."):
            calc_consensus(graph, lrs, cfg,
                           log_path=f"{out_dir}/log_consensus.txt",
                           mesh=mesh)

        with _step(t, "stitch", "generating the assembly from the cleaned "
                   "backbone graph..."):
            bridge_chains = None
            if cfg.resolve_repeats:
                # the same unique-anchor filter build_graph applies
                thresh = uniq_freq * (1 + cfg.max_uniq_dev)
                bridge_chains = [
                    [a for a in chain if contigs.mean_kmer[a.t_id] <= thresh]
                    for chain in compact
                ]
            nb_ctg = get_assembly(
                graph,
                contigs,
                out_dir,
                warn=lambda m: print(f"[WARNING] {m}", file=log),
                bridge_chains=bridge_chains,
                min_bridge_support=cfg.min_bridge_support,
            )

    return {
        "uniq_freq": uniq_freq,
        "n_alignments": n_aln,
        "n_edges": n_edges,
        "n_contigs_out": nb_ctg,
        "removed": removed,
        "assembly": f"{out_dir}/asm.final.fa",
    }
