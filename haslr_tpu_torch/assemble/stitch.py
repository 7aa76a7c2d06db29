"""Final assembly: extract simple paths from the cleaned graph and stitch
contig segments with edge consensus sequences.

Replaces reference ``asm_extract_all_simple_paths`` /
``asm_assemble_single_path`` / ``asm_get_assembly``
(``Assemble.cpp:607-810,1045-1112``), producing ``asm.final.fa`` plus the
``asm.final.ann`` provenance annotation (every output base attributed to a
contig segment or a consensus segment).
"""

from __future__ import annotations

from collections import deque

from haslr_tpu_torch.assemble import backbone as bb
from haslr_tpu_torch.core import seq as cseq

FLAG_PATH = 21


def find_simple_path_unbounded(graph, src_node, src_strand, first_key):
    """Unbounded simple-path walk (``asm_find_simple_path_from_source``,
    Assemble.cpp:607-622)."""
    path = deque([(src_node, src_strand)])
    curr_node, curr_strand = first_key >> 1, first_key & 1
    while True:
        path.append((curr_node, curr_strand))
        out = graph[curr_node].edges[curr_strand]
        inn = graph[curr_node].edges[1 - curr_strand]
        if len(out) == 0:
            break
        if len(out) > 1 or len(inn) > 1:
            break
        key = out.first_key()
        curr_node, curr_strand = key >> 1, key & 1
    return path


def extract_all_simple_paths(graph):
    """``asm_extract_all_simple_paths`` (Assemble.cpp:757-810): every edge
    belongs to exactly one path (flag 21 marks visits); isolated
    branch-both-sides nodes are emitted as singletons; branching endpoints
    are trimmed off the path."""
    path_list = []
    for i, node in enumerate(graph):
        n_out, n_in = len(node.edges[0]), len(node.edges[1])
        if n_out == 1 and n_in == 1:
            continue  # interior of some path
        if n_out > 1 and n_in > 1:
            path_list.append(deque([(i, 0)]))
        for rev in (0, 1):
            for key, edge in node.edges[rev].items():
                if edge.flag == FLAG_PATH:
                    continue
                path = find_simple_path_unbounded(graph, i, rev, key)
                for j in range(len(path) - 1):
                    n1, r1 = path[j]
                    n2, r2 = path[j + 1]
                    graph[n1].edges[r1][bb.edge_key(n2, r2)].flag = FLAG_PATH
                    graph[n2].edges[1 - r2][bb.edge_key(n1, 1 - r1)].flag = (
                        FLAG_PATH
                    )
                n1, r1 = path[0]
                if len(graph[n1].edges[r1]) > 1:
                    path.popleft()
                if path:
                    n2, r2 = path[-1]
                    if len(graph[n2].edges[1 - r2]) > 1:
                        path.pop()
                if path:
                    path_list.append(path)
    return path_list


def assemble_single_path(
    path, graph, contigs, nb_ctg, fp_asm, fp_ann=None, fp_log=None, warn=None
) -> int:
    """Stitch one path into output contig(s)
    (``asm_assemble_single_path``, Assemble.cpp:624-755).  Edges whose
    consensus had no support break the output contig.  Returns the updated
    contig counter."""

    def contig_str(node_id):
        return contigs.get_str(graph[node_id].contig_id)

    def emit(name_parts, seq):
        header = ">{} from:{}:{} to:{}:{}".format(*name_parts)
        fp_asm.write(f"{header}\n{seq}\n")
        if fp_log:
            fp_log.write(f"{header}\n{seq}\n\n")

    if len(path) == 1:
        c, s = path[0]
        emit((nb_ctg, c, "+-"[s], c, "+-"[s]), contig_str(c))
        return nb_ctg + 1

    assembled = []
    asm_len = 0
    source_contig, source_strand = path[0]
    contig1_start = (
        0 if source_strand == 0 else contigs.length(graph[source_contig].contig_id) - 1
    )
    for i in range(len(path) - 1):
        contig1, strand1 = path[i]
        contig2, strand2 = path[i + 1]
        c1 = contig_str(contig1)
        edge1 = graph[contig1].edges[strand1][bb.edge_key(contig2, strand2)]
        if len(edge1.cns_supp) == 0:
            # break the assembly (Assemble.cpp:682-706)
            if strand1 == 0:
                prefix = c1[contig1_start:]
                if fp_ann:
                    fp_ann.write(
                        f"{nb_ctg}\t{asm_len}\t{asm_len + len(prefix)}\tctg\t+"
                        f"\t{contig1}\t{len(c1)}\t{contig1_start}\t{len(c1)}\n"
                    )
            else:
                prefix = c1[: contig1_start + 1]
                if fp_ann:
                    fp_ann.write(
                        f"{nb_ctg}\t{asm_len}\t{asm_len + len(prefix)}\tctg\t-"
                        f"\t{contig1}\t{len(c1)}\t0\t{contig1_start + 1}\n"
                    )
                prefix = cseq.revcomp(prefix)
            assembled.append(prefix)
            emit(
                (nb_ctg, source_contig, "+-"[source_strand], contig1, "+-"[strand1]),
                "".join(assembled),
            )
            nb_ctg += 1
            assembled = []
            asm_len = 0
            source_contig, source_strand = contig2, strand2
            contig1_start = (
                0
                if source_strand == 0
                else contigs.length(graph[source_contig].contig_id) - 1
            )
            if warn:
                warn(
                    f"breaking assembly between anchors {contig1}:{'+-'[strand1]}"
                    f" --> {contig2}:{'+-'[strand2]}"
                )
        else:
            if strand1 == 0:
                prefix = c1[contig1_start : edge1.head_end + 1]
                if fp_ann:
                    fp_ann.write(
                        f"{nb_ctg}\t{asm_len}\t{asm_len + len(prefix)}\tctg\t+"
                        f"\t{contig1}\t{len(c1)}\t{contig1_start}"
                        f"\t{contig1_start + len(prefix)}\n"
                    )
            else:
                prefix = c1[edge1.head_end : contig1_start + 1]
                if fp_ann:
                    fp_ann.write(
                        f"{nb_ctg}\t{asm_len}\t{asm_len + len(prefix)}\tctg\t-"
                        f"\t{contig1}\t{len(c1)}\t{edge1.head_end}"
                        f"\t{edge1.head_end + len(prefix)}\n"
                    )
                prefix = cseq.revcomp(prefix)
            assembled.append(prefix)
            asm_len += len(prefix)
            if fp_ann:
                fp_ann.write(
                    f"{nb_ctg}\t{asm_len}\t{asm_len + len(edge1.cns_seq)}\tcns"
                    f"\t{len(edge1.cns_seq)}\t{len(edge1.cns_supp)}\n"
                )
            assembled.append(edge1.cns_seq)
            asm_len += len(edge1.cns_seq)
            contig1_start = edge1.tail_beg
    # last contig suffix (Assemble.cpp:734-750)
    contig2, strand2 = path[-1]
    c2 = contig_str(contig2)
    if strand2 == 0:
        suffix = c2[contig1_start:]
        if fp_ann:
            fp_ann.write(
                f"{nb_ctg}\t{asm_len}\t{asm_len + len(suffix)}\tctg\t+"
                f"\t{contig2}\t{len(c2)}\t{contig1_start}\t{len(c2)}\n"
            )
    else:
        suffix = c2[: contig1_start + 1]
        if fp_ann:
            fp_ann.write(
                f"{nb_ctg}\t{asm_len}\t{asm_len + len(suffix)}\tctg\t-"
                f"\t{contig2}\t{len(c2)}\t0\t{contig1_start + 1}\n"
            )
        suffix = cseq.revcomp(suffix)
    assembled.append(suffix)
    emit(
        (nb_ctg, source_contig, "+-"[source_strand], contig2, "+-"[strand2]),
        "".join(assembled),
    )
    return nb_ctg + 1


def identify_unused_longreads(graph, path_list, lrs, out_path: str) -> int:
    """Dump long reads not used by any assembled path
    (``asm_identify_unused_longreads``, Assemble.cpp:963-1043; its call is
    disabled in the reference main but the capability ships).  Reads
    supporting edges of path-end nodes are marked ``tail`` (value 2) —
    candidates for extending the assembly."""
    unused = [1] * len(lrs)

    def mark(node_id, value):
        for rev in (0, 1):
            for _key, edge in graph[node_id].edges[rev].items():
                for s in edge.edge_supp:
                    unused[s.lr_id] = value

    for path in path_list:
        for node_id, _strand in path:
            mark(node_id, 0)
    for path in path_list:
        mark(path[0][0], 2)
        mark(path[-1][0], 2)
    n = 0
    with open(out_path, "w") as fp:
        for rid, u in enumerate(unused):
            if u:
                tag = " tail" if u == 2 else " "
                fp.write(f">u{rid}{tag}\n{lrs.get_str(rid)}\n")
                n += 1
    return n


def _shared_supp_count(supp1, supp2) -> int:
    """``asm_get_shared_supp`` (Assemble.cpp:812-823)."""
    return len({s.lr_id for s in supp1} & {s.lr_id for s in supp2})


def resolve_4way_paths(graph, path_list):
    """Merge simple paths through 2-in/2-out nodes when edge-support
    pairing is decisive (``asm_resolve_4way_nodes`` + ``asm_connect_paths``,
    Assemble.cpp:825-961; shipped disabled in the reference main).

    Returns a deleted-path mask; surviving merged paths replace their
    sources in ``path_list`` in place.
    """
    deleted = [0] * len(path_list)
    tails = {}
    for i, path in enumerate(path_list):
        tails[(path[0][0], path[0][1])] = (i, 0)
        tails[(path[-1][0], 1 - path[-1][1])] = (i, 1)

    def connect(middle, in_key, out_key, delete_middle):
        it_in = tails.get((in_key >> 1, in_key & 1))
        it_out = tails.get((out_key >> 1, out_key & 1))
        if it_in is None or it_out is None:
            return
        pid1, side1 = it_in
        pid2, side2 = it_out
        if pid1 == pid2:
            deleted[middle] = 1
            return
        merged = deque()
        src = path_list[pid1]
        if side1 == 0:  # joined at its front: traverse reversed
            merged.extend((n, 1 - s) for n, s in reversed(src))
        else:
            merged.extend(src)
        merged.extend(path_list[middle])
        dst = path_list[pid2]
        if side2 == 0:
            merged.extend(dst)
        else:
            merged.extend((n, 1 - s) for n, s in reversed(dst))
        for pid in (pid1, pid2):
            pp = path_list[pid]
            tails.pop((pp[0][0], pp[0][1]), None)
            tails.pop((pp[-1][0], 1 - pp[-1][1]), None)
        if delete_middle:
            pp = path_list[middle]
            tails.pop((pp[0][0], pp[0][1]), None)
            tails.pop((pp[-1][0], 1 - pp[-1][1]), None)
            deleted[middle] = 1
        tails[(merged[0][0], merged[0][1])] = (pid1, 0)
        tails[(merged[-1][0], 1 - merged[-1][1])] = (pid1, 1)
        path_list[pid1] = merged
        deleted[pid2] = 1

    for i, path in enumerate(path_list):
        if deleted[i]:
            continue
        node1, strand1 = path[0]
        node2, strand2 = path[-1]
        out_map = graph[node2].edges[strand2]
        in_map = graph[node1].edges[1 - strand1]
        if len(out_map) != 2 or len(in_map) != 2:
            continue
        in1, in2 = in_map.nth_key(0), in_map.nth_key(1)
        out1, out2 = out_map.nth_key(0), out_map.nth_key(1)
        s11 = _shared_supp_count(in_map[in1].edge_supp, out_map[out1].edge_supp)
        s12 = _shared_supp_count(in_map[in1].edge_supp, out_map[out2].edge_supp)
        s21 = _shared_supp_count(in_map[in2].edge_supp, out_map[out1].edge_supp)
        s22 = _shared_supp_count(in_map[in2].edge_supp, out_map[out2].edge_supp)
        if (s11 > 2 * s12 and not s21 > 2 * s22) or (
            s22 > 2 * s21 and not s12 > 2 * s11
        ):
            connect(i, in1, out1, False)
            connect(i, in2, out2, True)
        elif (s12 > 2 * s11 and not s22 > 2 * s21) or (
            s21 > 2 * s22 and not s11 > 2 * s12
        ):
            connect(i, in1, out2, False)
            connect(i, in2, out1, True)
    return deleted


def get_assembly(graph, contigs, out_dir: str, warn=None,
                 bridge_chains=None, min_bridge_support: int = 2) -> int:
    """``asm_get_assembly`` (Assemble.cpp:1045-1077): write asm.final.fa,
    asm.final.ann and log_asmfinal.txt.  Returns the output contig count.

    ``bridge_chains``: optional unique-anchor compact chains; when given,
    simple paths are joined through read-supported repeat routes before
    stitching (the wired-up Align_LR2path capability — see
    ``repeat.merge_bridged_paths``) and the joins land in
    ``log_repeat.txt``."""
    path_list = extract_all_simple_paths(graph)
    if bridge_chains is not None:
        from haslr_tpu_torch.assemble.repeat import merge_bridged_paths

        with open(f"{out_dir}/log_repeat.txt", "w") as fp_rep:
            path_list = merge_bridged_paths(
                graph, path_list, bridge_chains,
                min_support=min_bridge_support, log=fp_rep,
            )
    nb_ctg = 0
    with open(f"{out_dir}/asm.final.fa", "w") as fp_asm, open(
        f"{out_dir}/asm.final.ann", "w"
    ) as fp_ann, open(f"{out_dir}/log_asmfinal.txt", "w") as fp_log:
        for i, path in enumerate(path_list):
            fp_log.write(
                f"simple_path {i} size:{len(path)}\tfrom:{path[0][0]}:"
                f"{'+-'[path[0][1]]}\tto:{path[-1][0]}:{'+-'[path[-1][1]]}\n"
            )
        for path in path_list:
            nb_ctg = assemble_single_path(
                path, graph, contigs, nb_ctg, fp_asm, fp_ann, fp_log, warn
            )
    return nb_ctg
