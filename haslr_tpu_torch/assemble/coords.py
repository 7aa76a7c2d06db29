"""Edge coordinate calculation: anchor the consensus windows.

For every backbone edge, pick the best-supported interval on the head and
tail contigs, intersect the supporting read sets, and project the interval
endpoints through each supporting read's CIGAR to get the long-read
subsequence spanning the gap between the two anchors.

Replaces reference ``asm_calc_single_edge_coordinates`` + the MT work queue
(``Assemble.cpp:157-477``).  The eight strand/orientation cases map onto
:func:`haslr_tpu_torch.core.cigar.project_target_to_query` with reversed op arrays
standing in for the reference's reversed expanded strings.
"""

from __future__ import annotations

from haslr_tpu_torch.assemble import backbone as bb
from haslr_tpu_torch.core import cigar as ccigar
from haslr_tpu_torch.core.intervals import best_supported_interval


def calc_single_edge_coordinates(
    graph, contigs, lrs, compact, node1, rev1, node2, rev2, fp_log=None
) -> None:
    edge1 = graph[node1].edges[rev1][bb.edge_key(node2, rev2)]
    edge2 = graph[node2].edges[1 - rev2][bb.edge_key(node1, 1 - rev1)]
    edge_supp = edge1.edge_supp
    if fp_log is not None:
        # record format of the reference log (Assemble.cpp:176-241),
        # including its "supproting_lr" spelling
        pm = "+-"
        fp_log.write(
            f"edge      {node1}:{pm[rev1]} -> {node2}:{pm[rev2]}\n"
            f"edge_twin {node2}:{pm[1 - rev2]} -> {node1}:{pm[1 - rev1]}\n"
            f"\tedge_supp size:{len(edge_supp)}\n"
        )

    def default_coords():
        edge1.cns_supp = []
        edge2.cns_supp = []
        v1 = contigs.length(graph[node1].contig_id) - 1 if rev1 == 0 else 0
        v2 = 0 if rev2 == 0 else contigs.length(graph[node2].contig_id) - 1
        edge1.head_end = edge2.tail_beg = v1
        edge1.tail_beg = edge2.head_end = v2

    # best supported interval on the head contig (>= update, Assemble.cpp:24)
    begs1 = [compact[s.lr_id][s.cmp_head_id].t_start for s in edge_supp]
    ends1 = [compact[s.lr_id][s.cmp_head_id].t_end for s in edge_supp]
    ids = list(range(len(edge_supp)))
    b1, e1, lrs1 = best_supported_interval(begs1, ends1, ids, strict=False)
    # best supported interval on the tail contig (> update, Assemble.cpp:76)
    begs2 = [compact[s.lr_id][s.cmp_tail_id].t_start for s in edge_supp]
    ends2 = [compact[s.lr_id][s.cmp_tail_id].t_end for s in edge_supp]
    b2, e2, lrs2 = best_supported_interval(begs2, ends2, ids, strict=True)

    # shared-region endpoints on the two contigs (Assemble.cpp:226-235)
    contig1_pos = e1 - 1 if rev1 == 0 else b1
    contig2_pos = b2 if rev2 == 0 else e2 - 1

    best = sorted(lrs1 & lrs2)
    if fp_log is not None:
        fp_log.write(
            f"    @@@ best interval contig1 {b1} {e1}\n"
            f"    @@@ best_interval contig2 {b2} {e2}\n"
            f"coordinates contig1_pos: {contig1_pos}\t"
            f"contig2_pos: {contig2_pos}\n"
            f"supproting_lr: {len(best)}\n"
        )
    if not best:
        default_coords()
        return

    edge1.cns_supp = []
    edge2.cns_supp = []
    for idx in best:
        s = edge_supp[idx]
        rid = s.lr_id
        rlen = lrs.length(rid)
        a1 = compact[rid][s.cmp_head_id]
        a2 = compact[rid][s.cmp_tail_id]
        rstrand = 0 if rev1 == a1.is_rev else 1
        # --- project contig1_pos / contig2_pos onto the read (8 cases,
        #     Assemble.cpp:269-324) ---
        r1 = ccigar.reverse(a1.ops, a1.lens)
        r2 = ccigar.reverse(a2.ops, a2.lens)
        if rstrand == 0:
            if rev1 == 0:   # case 1
                lr_start = ccigar.project_target_to_query(
                    a1.ops, a1.lens, a1.q_start, a1.t_start, +1, +1, contig1_pos
                )
            else:           # case 2
                lr_start = ccigar.project_target_to_query(
                    *r1, a1.q_start, a1.t_end - 1, +1, -1, contig1_pos
                )
            if rev2 == 0:   # case 3
                lr_end = ccigar.project_target_to_query(
                    *r2, a2.q_end - 1, a2.t_end - 1, -1, -1, contig2_pos
                )
            else:           # case 4
                lr_end = ccigar.project_target_to_query(
                    a2.ops, a2.lens, a2.q_end - 1, a2.t_start, -1, +1, contig2_pos
                )
        else:
            if rev1 == 0:   # case 5
                lr_start = ccigar.project_target_to_query(
                    a1.ops, a1.lens, rlen - a1.q_end, a1.t_start, +1, +1,
                    contig1_pos,
                )
            else:           # case 6
                lr_start = ccigar.project_target_to_query(
                    *r1, rlen - a1.q_end, a1.t_end - 1, +1, -1, contig1_pos
                )
            if rev2 == 0:   # case 7
                lr_end = ccigar.project_target_to_query(
                    *r2, rlen - a2.q_start - 1, a2.t_end - 1, -1, -1,
                    contig2_pos,
                )
            else:           # case 8
                lr_end = ccigar.project_target_to_query(
                    a2.ops, a2.lens, rlen - a2.q_start - 1, a2.t_start, -1, +1,
                    contig2_pos,
                )
        if lr_start is not None and lr_end is not None:
            edge1.cns_supp.append(
                bb.CnsSupp(rid, rstrand, lr_start + 1, lr_end - 1)
            )
            edge2.cns_supp.append(
                bb.CnsSupp(
                    rid,
                    1 - rstrand,
                    rlen - (lr_end - 1) - 1,
                    rlen - (lr_start + 1) - 1,
                )
            )
    if edge1.cns_supp:
        edge1.head_end = edge2.tail_beg = contig1_pos
        edge1.tail_beg = edge2.head_end = contig2_pos
    else:
        default_coords()


def calc_edge_coordinates(graph, contigs, lrs, compact,
                          log_path: str | None = None) -> int:
    """Coordinates for every unique edge; marks flag 11 like the reference
    work queue (Assemble.cpp:436-477).  Returns the edge count.

    ``log_path``: when given, a per-edge record log in the reference's
    ``log_coordinate.txt`` format (main.cpp:203)."""
    n = 0
    fp_log = open(log_path, "w") if log_path else None
    try:
        for n1, r1, n2, r2, edge, twin in bb.unique_edges(graph):
            if edge.flag == 11:
                continue
            edge.flag = 11
            twin.flag = 11
            calc_single_edge_coordinates(
                graph, contigs, lrs, compact, n1, r1, n2, r2, fp_log
            )
            n += 1
    finally:
        if fp_log:
            fp_log.close()
    return n
