"""Per-edge consensus with the port's engine (port of
:func:`haslr_tpu.assemble.consensus.calc_consensus`).

``consensus_engine == "tpu"`` — the shared config's name for "the device
engine" — polishes every edge's window on the torch device
(:mod:`haslr_tpu_torch.kernels.consensus`); ``"poa"`` runs the host
partial-order alignment.  Edge selection, the window subsequences
(:func:`_edge_window_seqs`), the host POA (:func:`_host_poa_windows`) and
the ``log_consensus.txt`` records are the port's copy of the reference's.
"""

from __future__ import annotations

import sys

import torch

from haslr_tpu_torch import trace
from haslr_tpu_torch.assemble import backbone as bb
from haslr_tpu_torch.config import AssembleConfig
from haslr_tpu_torch.core import seq as cseq


def _edge_window_seqs(edge: bb.BBGEdge, lrs) -> list[str]:
    """Extract the supporting subsequences of one edge, replicating the
    reference's substring semantics (Assemble.cpp:503-543): positions are
    inclusive on the chosen strand; ``spos == epos + 1`` yields an empty
    string, and ``spos > epos + 1`` — an unsigned-underflow artifact in the
    C++ — yields the whole suffix from ``spos``."""
    out = []
    for s in edge.cns_supp:
        rseq = lrs.get_str(s.lr_id)
        if s.lr_strand:
            rseq = cseq.revcomp(rseq)
        if s.epos + 1 < s.spos:
            out.append(rseq[s.spos:])
        else:
            out.append(rseq[s.spos : s.epos + 1])
    return out


def calc_consensus(
    graph, lrs, cfg: AssembleConfig | None = None,
    device: torch.device | str | None = None, log_path: str | None = None,
    mesh=None,
) -> int:
    """Consensus for every unique edge; flags edges 12 like the reference
    work queue.  Returns the number of edges processed.  The device
    engine runs on ``device`` (the card unless the caller says ``"cpu"``)
    or, given a ``dp`` :class:`~haslr_tpu_torch.dist.mesh.Mesh`, over its
    devices, with the same output.  Spans ``consensus.edges`` (the edge
    loop and the twins' reverse complements), ``consensus.windows`` (the
    extraction: counts ``consensus.extract.bases``, the whole lengths of
    the reads it decodes, and ``consensus.extract.kept``, the lengths of
    the subsequences it keeps) and ``consensus.log``."""
    cfg = cfg or AssembleConfig()
    if cfg.consensus_engine == "tpu":
        from haslr_tpu_torch.dist.mesh import as_mesh

        mesh = as_mesh(device, mesh)
    edges = []
    with trace.span("consensus.edges"):
        for _n1, _r1, _n2, _r2, edge, twin in bb.unique_edges(graph):
            if edge.flag == 12:
                continue
            edge.flag = 12
            twin.flag = 12
            edges.append((edge, twin))

    with trace.span("consensus.windows"):
        windows = [_edge_window_seqs(edge, lrs) for edge, _ in edges]
        if trace.on():
            # each (window, read) pair decodes the whole read
            trace.count("consensus.extract.bases", sum(
                int(lrs.length(s.lr_id)) for edge, _ in edges
                for s in edge.cns_supp))
            trace.count("consensus.extract.kept",
                        sum(len(sub) for subs in windows for sub in subs))
    if cfg.consensus_engine == "tpu":
        from haslr_tpu_torch.kernels.consensus import batched_consensus

        def _warn(msg):
            print(f"[WARNING] {msg}", file=sys.stderr)

        results = batched_consensus(
            windows, match=cfg.poa_match, mismatch=cfg.poa_mismatch,
            gap=cfg.poa_gap, warn=_warn, mesh=mesh,
        )
    else:
        results = _host_poa_windows(
            windows, cfg.poa_match, cfg.poa_mismatch, cfg.poa_gap
        )
    with trace.span("consensus.edges"):
        for (edge, twin), cns in zip(edges, results):
            edge.cns_seq = cns
            twin.cns_seq = cseq.revcomp(cns)
    if log_path is not None:
        with trace.span("consensus.log"), open(log_path, "w") as fp:
            for (edge, _twin), subs in zip(edges, windows):
                fp.write(
                    f"[shared_region] head_end:{edge.head_end}\t"
                    f"tail_beg:{edge.tail_beg}\n"
                )
                for s, sub in zip(edge.cns_supp, subs):
                    fp.write(
                        f">{s.lr_id} {'-' if s.lr_strand else '+'} "
                        f"{s.spos} {s.epos} {s.epos - s.spos + 1}\n"
                        f"{sub}\n"
                    )
                fp.write(f">CONSENSUS\n{edge.cns_seq}\n")
    return len(edges)


def _host_poa_windows(windows, match, mismatch, gap):
    """Exact POA per window on host: the native C++ engine (the SPOA-
    grade batch engine, haslr_tpu_torch/native/poa.cpp) when available, else
    the Python reference engine — both bit-identical."""
    from haslr_tpu_torch import native

    code_wins = [
        [cseq.encode(s) for s in seqs if len(s) > 0] for seqs in windows
    ]
    out = native.poa_consensus_native(code_wins, match, mismatch, gap)
    if out is not None:
        return [cseq.decode(c) for c in out]
    from haslr_tpu_torch.assemble.poa import poa_consensus

    return [
        poa_consensus(seqs, match, mismatch, gap) for seqs in windows
    ]
