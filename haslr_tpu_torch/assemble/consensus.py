"""Per-edge consensus with the port's engine (port of
:func:`haslr_tpu.assemble.consensus.calc_consensus`).

``consensus_engine == "tpu"`` — the shared config's name for "the device
engine" — polishes every edge's window on the torch device
(:mod:`haslr_tpu_torch.kernels.consensus`); ``"poa"`` runs the shared host
partial-order alignment.  Edge selection, the window subsequences and the
``log_consensus.txt`` records are the reference's.
"""

from __future__ import annotations

import sys

import torch

from haslr_tpu.assemble import backbone as bb
from haslr_tpu.assemble.consensus import _edge_window_seqs, _host_poa_windows
from haslr_tpu.config import AssembleConfig
from haslr_tpu.core import seq as cseq


def calc_consensus(
    graph, lrs, cfg: AssembleConfig | None = None,
    device: torch.device | str = "cpu", log_path: str | None = None,
) -> int:
    """Consensus for every unique edge; flags edges 12 like the reference
    work queue.  Returns the number of edges processed."""
    cfg = cfg or AssembleConfig()
    edges = []
    for _n1, _r1, _n2, _r2, edge, twin in bb.unique_edges(graph):
        if edge.flag == 12:
            continue
        edge.flag = 12
        twin.flag = 12
        edges.append((edge, twin))

    windows = [_edge_window_seqs(edge, lrs) for edge, _ in edges]
    if cfg.consensus_engine == "tpu":
        from haslr_tpu_torch.kernels.consensus import batched_consensus

        def _warn(msg):
            print(f"[WARNING] {msg}", file=sys.stderr)

        results = batched_consensus(
            windows, match=cfg.poa_match, mismatch=cfg.poa_mismatch,
            gap=cfg.poa_gap, warn=_warn, device=device,
        )
    else:
        results = _host_poa_windows(
            windows, cfg.poa_match, cfg.poa_mismatch, cfg.poa_gap
        )
    for (edge, twin), cns in zip(edges, results):
        edge.cns_seq = cns
        twin.cns_seq = cseq.revcomp(cns)
    if log_path is not None:
        with open(log_path, "w") as fp:
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
