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

import os
import sys
import time

import torch

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
from haslr_tpu_torch.device import resolve_device


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


def _load_inputs(contig_path, long_path, mapping_path, out_dir, cfg, t,
                 log, long_fofn, mapping_fofn):
    """Steps 1-3: contigs, their unique-k-mer frequency, long reads and
    alignments — each from its snapshot when one exists."""
    contig_idx = f"{out_dir}/index.contig.npz"
    if os.path.isfile(contig_idx):
        t.note(f"reading contig index: {contig_idx}...")
        contigs = index_io.read_contig_index(contig_idx)
    else:
        t.note("loading contig sequences...")
        contigs = ContigStore.load_fasta(contig_path)
        index_io.write_contig_index(contig_idx, contigs)
    print(f"       loaded {len(contigs)} contigs", file=log)
    t.elapsed()

    t.note("calculating kmer frequency of unique contigs")
    uniq_freq = contigs.calc_uniq_freq()
    print(f"       mean: {uniq_freq:.2f}", file=log)
    t.elapsed()

    lr_idx = f"{out_dir}/index.longread.npz"
    if os.path.isfile(lr_idx):
        t.note(f"reading long read and alignment index: {lr_idx}...")
        lrs, n_aln = index_io.read_longread_index(lr_idx)
        print(f"       loaded {len(lrs)} long reads", file=log)
        print(f"       loaded {n_aln} alignments", file=log)
        t.elapsed()
        return contigs, uniq_freq, lrs, n_aln

    t.note("loading long read sequences...")
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
    t.elapsed()

    t.note("loading alignment between contigs and long reads...")
    n_aln = 0
    for p in read_fofn(mapping_path) if mapping_fofn else [mapping_path]:
        n_aln += load_alignments(p, contigs, lrs, uniq_freq, cfg)
    print(f"       loaded {n_aln} alignments", file=log)
    index_io.write_longread_index(lr_idx, lrs)
    t.elapsed()
    return contigs, uniq_freq, lrs, n_aln


def _clean(graph, contigs, out_dir, cfg, t, log):
    """Steps 6-10: the cleaning cascade with its stat/GFA snapshots;
    returns the removal counts."""

    def snapshot(tag):
        bb.general_stats(graph, contigs, f"{out_dir}/backbone.{tag}.stat")
        bb.write_gfa(graph, contigs, f"{out_dir}/backbone.{tag}.gfa")
        t.elapsed()

    t.note("cleaning weak edges...")
    nb_weak = bb.remove_weak_edges(graph, cfg.min_edge_sup)
    print(f"       removed {nb_weak} edges", file=log)
    snapshot("02.weakEdge")

    t.note("cleaning tips...")
    nb_tips = 0
    with open(f"{out_dir}/backbone.03.tip.log", "w") as tip_log:
        for depth in cfg.tip_depths:
            nb_tips += cleaning.clean_tips(graph, depth, tip_log)
    print(f"       removed {nb_tips} tips", file=log)
    snapshot("03.tip")

    t.note("cleaning simple bubbles...")
    with open(f"{out_dir}/backbone.04.simplebubble.log", "w") as sb_log:
        nb_simple = cleaning.clean_simple_bubbles_old(
            graph, cfg.simple_bubble_depth, sb_log
        )
    print(f"       removed {nb_simple} simple bubbles", file=log)
    snapshot("04.simplebubble")

    t.note("cleaning super bubbles...")
    with open(f"{out_dir}/backbone.05.superbubble.log", "w") as sup_log:
        nb_super = cleaning.clean_super_bubbles(
            graph, cfg.super_bubble_max_dist, sup_log
        )
    print(f"       removed {nb_super} super bubbles", file=log)
    snapshot("05.superbubble")

    t.note("cleaning small bubbles...")
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
) -> dict:
    """Full assembler run with consensus on ``device`` (the card unless
    the caller says ``"cpu"``); returns a stats dict (uniq_freq,
    edge/contig counts, output path).
    ``long_fofn``/``mapping_fofn`` read the paths as file-of-file-names
    like the reference's ``--long-fofn``/``--mapping-fofn``."""
    cfg = cfg or AssembleConfig()
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t = StageTimer(log)
    contigs, uniq_freq, lrs, n_aln = _load_inputs(
        contig_path, long_path, mapping_path, out_dir, cfg, t, log,
        long_fofn, mapping_fofn,
    )

    t.note("fixing overlapping alignments...")
    fix_alignments(lrs)
    t.elapsed()

    t.note("building compact long reads...")
    compact = build_compact_longreads(lrs, contigs, uniq_freq, cfg,
                                      copy_count=1)
    write_compact_longreads(compact, f"{out_dir}/compact_uniq.txt")
    t.elapsed()

    t.note("building the backbone graph...")
    graph = bb.build_graph(contigs, compact, uniq_freq, cfg)
    bb.general_stats(graph, contigs, f"{out_dir}/backbone.01.init.stat")
    bb.write_gfa(graph, contigs, f"{out_dir}/backbone.01.init.gfa")
    t.elapsed()

    removed = _clean(graph, contigs, out_dir, cfg, t, log)
    bb.report_branching_nodes(graph, f"{out_dir}/backbone.branching.log")

    t.note("calculating long read coordinates between anchors...")
    n_edges = calc_edge_coordinates(
        graph, contigs, lrs, compact,
        log_path=f"{out_dir}/log_coordinate.txt",
    )
    t.elapsed()

    t.note("calling consensus sequence between anchors...")
    calc_consensus(graph, lrs, cfg, device=device,
                   log_path=f"{out_dir}/log_consensus.txt")
    t.elapsed()

    t.note("generating the assembly from the cleaned backbone graph...")
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
    t.elapsed()

    return {
        "uniq_freq": uniq_freq,
        "n_alignments": n_aln,
        "n_edges": n_edges,
        "n_contigs_out": nb_ctg,
        "removed": removed,
        "assembly": f"{out_dir}/asm.final.fa",
    }
