"""Backbone graph cleaning: weak edges, tips, simple/super/small bubbles.

Replaces reference ``Cleaning.cpp``.  Heuristic order and tie-breaking are
reproduced exactly, including the ``i--`` restart after a removed bubble
(``Cleaning.cpp:140-141,603-604``), begin()/second-key edge selection on the
ordered edge maps, and the literal scoring expression of the super-bubble
sweep (``Cleaning.cpp:526``, including its division-by-zero semantics).
"""

from __future__ import annotations

import math

from haslr_tpu_torch.assemble import backbone as bb


def clean_tips(graph, max_depth: int, log=None) -> int:
    """Remove dead-end paths of length <= max_depth whose far end still
    connects to the graph (``clean_tips``, Cleaning.cpp:59-96)."""
    removed = 0
    for i, node in enumerate(graph):
        if len(node.edges[1]) == 0 and len(node.edges[0]) == 1:
            src_strand = 0
        elif len(node.edges[1]) == 1 and len(node.edges[0]) == 0:
            src_strand = 1
        else:
            continue
        first_key = node.edges[src_strand].first_key()
        ok, path, _cov = bb.find_simple_path_from_source(
            graph, i, src_strand, first_key, max_depth
        )
        if not ok:
            continue
        end_node, end_strand = path[-1]
        if len(graph[end_node].edges[end_strand]) == 0:
            continue  # ends at a dead end: keep
        if log:
            log.write(
                f"tip_len:{len(path) - 1}\t{path[0][0]}:{'+-'[path[0][1]]}"
                f" -> {end_node}:{'+-'[end_strand]}\n"
            )
        for j in range(len(path) - 1):
            bb.remove_edge(
                graph, path[j][0], path[j][1], path[j + 1][0], path[j + 1][1]
            )
        removed += 1
    return removed


def _log_bubble(log, cov1, path1, cov2, path2):
    if not log:
        return
    log.write(f"simple_bubble cov:{cov1:.2f} ")
    log.write(" ".join(f"{n}:{'+-'[s]}" for n, s in path1))
    log.write(f" \n              cov:{cov2:.2f} ")
    log.write(" ".join(f"{n}:{'+-'[s]}" for n, s in path2))
    log.write(" \n")


def clean_simple_bubbles_old(graph, max_depth: int, log=None) -> int:
    """Two-path bubble popping, keeping the higher-coverage side
    (``clean_simple_bubbles_old``, Cleaning.cpp:98-184).  On a removal the
    same node is re-examined (the reference's ``i--`` restart)."""
    removed = 0
    i = 0
    num = len(graph)
    while i < num:
        node = graph[i]
        if len(node.edges[0]) < 2 and len(node.edges[1]) < 2:
            i += 1
            continue
        restarted = False
        for side in (0, 1):
            if len(node.edges[side]) != 2:
                continue
            k1 = node.edges[side].nth_key(0)
            k2 = node.edges[side].nth_key(1)
            ok1, path1, cov1 = bb.find_simple_path_from_source(
                graph, i, side, k1, max_depth
            )
            ok2, path2, cov2 = bb.find_simple_path_from_source(
                graph, i, side, k2, max_depth
            )
            if ok1 and ok2 and path1[-1] == path2[-1]:
                _log_bubble(log, cov1, path1, cov2, path2)
                drop = path1 if cov1 < cov2 else path2
                for j in range(len(drop) - 1):
                    bb.remove_edge(
                        graph, drop[j][0], drop[j][1], drop[j + 1][0], drop[j + 1][1]
                    )
                removed += 1
                restarted = True
                break  # re-examine node i from scratch
        if not restarted:
            i += 1
    return removed


def get_shared_lr_supp(edge1_supp, edge2_supp):
    """Intersect two sorted support lists by lr_id
    (``get_shared_lr_supp``, Cleaning.cpp:191-241): the shared record takes
    the head anchor from edge1 and the tail anchor from edge2."""
    for supp in (edge1_supp, edge2_supp):
        for a, b in zip(supp, supp[1:]):
            if a.lr_id > b.lr_id:
                raise AssertionError(
                    "(cleaning::get_shared_lr_supp) support list not sorted"
                )
    shared = []
    i = j = 0
    while i < len(edge1_supp) and j < len(edge2_supp):
        s1, s2 = edge1_supp[i], edge2_supp[j]
        if s1.lr_id == s2.lr_id:
            if s1.lr_strand != s2.lr_strand:
                raise AssertionError(
                    "(cleaning::get_shared_lr_supp) same supporting long read"
                    " has different strand"
                )
            shared.append(
                bb.EdgeSupp(s1.lr_id, s1.lr_strand, s1.cmp_head_id, s2.cmp_tail_id)
            )
            i += 1
            j += 1
        elif s1.lr_id < s2.lr_id:
            i += 1
        else:
            j += 1
    shared.sort(key=lambda s: s.lr_id)
    return shared


def clean_simple_bubbles(graph, max_depth: int, log=None) -> int:
    """Bubble popping with shared-support rescue — the newer variant that the
    reference ships but does not call (``clean_simple_bubbles``,
    Cleaning.cpp:243-483; call commented out at main.cpp:176)."""
    removed = 0
    i = 0
    num = len(graph)
    while i < num:
        node = graph[i]
        if len(node.edges[0]) < 2 and len(node.edges[1]) < 2:
            i += 1
            continue
        restarted = False
        for side in (0, 1):
            if len(node.edges[side]) != 2:
                continue
            k1 = node.edges[side].nth_key(0)
            k2 = node.edges[side].nth_key(1)
            edge_start_1 = node.edges[side][k1]
            edge_start_2 = node.edges[side][k2]
            ok1, path1, cov1 = bb.find_simple_path_from_source(
                graph, i, side, k1, max_depth
            )
            ok2, path2, cov2 = bb.find_simple_path_from_source(
                graph, i, side, k2, max_depth
            )
            if not (ok1 and ok2 and path1[-1] == path2[-1]):
                continue
            _log_bubble(log, cov1, path1, cov2, path2)
            edge_end_1 = bb.get_edge(
                graph, path1[-2][0], path1[-2][1], path1[-1][0], path1[-1][1]
            )
            edge_end_2 = bb.get_edge(
                graph, path2[-2][0], path2[-2][1], path2[-1][0], path2[-1][1]
            )
            shared = get_shared_lr_supp(
                edge_start_1.edge_supp, edge_end_1.edge_supp
            )
            shared += get_shared_lr_supp(
                edge_start_2.edge_supp, edge_end_2.edge_supp
            )
            if log:
                log.write(f"       shared cov:{len(shared)}\n")

            def drop(path):
                for j in range(len(path) - 1):
                    bb.remove_edge(
                        graph, path[j][0], path[j][1], path[j + 1][0], path[j + 1][1]
                    )

            # keep the longer path when its coverage ties-or-beats the other;
            # otherwise prefer the reads spanning the whole bubble when they
            # outnumber the winner (Cleaning.cpp:296-359)
            long_p, long_c, short_p, short_c = (
                (path1, cov1, path2, cov2)
                if len(path1) > len(path2)
                else (path2, cov2, path1, cov1)
            )
            if long_c >= short_c:
                drop(short_p)
            elif len(shared) > short_c:
                drop(path1)
                drop(path2)
                bb.add_edge_with_supp(
                    graph,
                    path1[0][0], path1[0][1],
                    path1[-1][0], path1[-1][1],
                    shared,
                )
            else:
                drop(long_p)
            removed += 1
            restarted = True
            break
        if not restarted:
            i += 1
    return removed


def detect_super_bubble(graph, max_dist, src_node, src_rev):
    """Topological super-bubble sweep keeping the best supported path
    (``detect_super_bubble``, Cleaning.cpp:488-562, miniasm Algorithm 6
    style; ``max_dist`` is unused, mirroring the reference TODO).

    Returns ``(found, best_path, bubble_edges)`` with vertices encoded
    ``(node << 1) | rev``.
    """
    start = (src_node << 1) | src_rev
    stack = [start]
    visited = {start: 1}
    gamma = {}
    path = {start: [start]}
    support = {start: 0}
    bubble_edges = set()
    p = 0
    while stack:
        v = stack.pop()
        curr_node, curr_rev = v >> 1, v & 1
        for key, edge in graph[curr_node].edges[curr_rev].items():
            bubble_edges.add((v, key))
            next_node, next_rev = key >> 1, key & 1
            next_supp = len(edge.edge_supp)
            w = key
            if next_node == curr_node:
                return False, [], set()  # circle involving the current node
            if w not in visited:
                gamma[w] = len(graph[next_node].edges[1 - next_rev])
                visited[w] = 1
                p += 1
            # literal transcription of Cleaning.cpp:526 (denominator is
            # len(path[v]) - 1, which is 0 at the source: C++ divides by
            # zero giving inf/nan and the comparison is then false)
            if w not in support:
                update = True
            else:
                denom = len(path[v]) - 1
                lhs = (support[v] + next_supp) / len(path[v])
                if denom == 0:
                    rhs = math.inf if support[w] > 0 else math.nan
                else:
                    rhs = support[w] / denom
                update = lhs > rhs
            if update:
                support[w] = support[v] + next_supp
                path[w] = path[v] + [w]
            gamma[w] -= 1
            if gamma[w] == 0:
                if len(graph[next_node].edges[next_rev]) > 0:
                    stack.append(w)
                    p -= 1
        if len(stack) == 1 and p == 0:
            return True, path[stack[-1]], bubble_edges
    return False, [], set()


def clean_super_bubbles(graph, max_dist: int, log=None) -> int:
    """Pop super bubbles, keeping the best supported path
    (``clean_super_bubbles``, Cleaning.cpp:565-648)."""
    removed = 0
    i = 0
    num = len(graph)
    while i < num:
        node = graph[i]
        if len(node.edges[0]) < 2 and len(node.edges[1]) < 2:
            i += 1
            continue
        restarted = False
        for side in (0, 1):
            if len(node.edges[side]) < 2:
                continue
            found, best_path, bubble_edges = detect_super_bubble(
                graph, max_dist, i, side
            )
            if not found:
                continue
            if log:
                log.write(
                    f"bubble_src {i}:{'+-'[side]}\tbubble_sink "
                    f"{best_path[-1] >> 1}:{'+-'[best_path[-1] & 1]}\n"
                )
                log.write(
                    "\tbest_path "
                    + " ".join(f"{v >> 1}:{'+-'[v & 1]}" for v in best_path)
                    + " \n"
                )
            for j in range(len(best_path) - 1):
                bubble_edges.discard((best_path[j], best_path[j + 1]))
            for v1, v2 in sorted(bubble_edges):
                bb.remove_edge(graph, v1 >> 1, v1 & 1, v2 >> 1, v2 & 1)
            removed += 1
            restarted = True
            break
        if not restarted:
            i += 1
    return removed


def clean_small_bubbles(graph, log=None) -> int:
    """Pop 1-edge-vs-2-edge shortcuts through a node, dropping the lower
    coverage side (``clean_small_bubbles``, Cleaning.cpp:7-57); at most one
    bubble per middle node, no restart."""
    removed = 0
    for i, node in enumerate(graph):
        if len(node.edges[1]) == 0 or len(node.edges[0]) == 0:
            continue
        detected = False
        for in_key, in_edge in node.edges[1].items():
            for out_key, out_edge in node.edges[0].items():
                node1, rev1 = in_key >> 1, in_key & 1
                node2, rev2 = out_key >> 1, out_key & 1
                if out_key not in graph[node1].edges[1 - rev1]:
                    continue
                short_cov = len(graph[node1].edges[1 - rev1][out_key].edge_supp)
                long_cov = (
                    len(in_edge.edge_supp) + len(out_edge.edge_supp)
                ) / 2.0
                if log:
                    log.write(
                        f"small_bubble cov:{short_cov:.2f} "
                        f"{node1}:{'+-'[1 - rev1]} -> {node2}:{'+-'[rev2]}\n"
                    )
                    log.write(
                        f"             cov:{long_cov:.2f} "
                        f"{node1}:{'+-'[1 - rev1]} -> {i}:+ -> "
                        f"{node2}:{'+-'[rev2]}\n"
                    )
                if short_cov < long_cov:
                    bb.remove_edge(graph, node1, 1 - rev1, node2, rev2)
                else:
                    bb.remove_edge(graph, node1, 1 - rev1, i, 0)
                    bb.remove_edge(graph, i, 0, node2, rev2)
                removed += 1
                detected = True
                break
            if detected:
                break
    return removed


def clean_resolve_4way_nodes(graph, log=None) -> int:
    """Split 2-in/2-out nodes whose in/out supports pair up cleanly, by
    duplicating the node (``clean_resolve_4way_nodes``,
    Cleaning.cpp:666-726; shipped but not called by the reference main)."""
    resolved = 0
    num = len(graph)
    for i in range(num):
        node = graph[i]
        if len(node.edges[1]) != 2 or len(node.edges[0]) != 2:
            continue
        in_keys = [node.edges[1].nth_key(0), node.edges[1].nth_key(1)]
        out_keys = [node.edges[0].nth_key(0), node.edges[0].nth_key(1)]
        supp_in = [
            {(s.lr_id << 1) | (1 - s.lr_strand) for s in node.edges[1][k].edge_supp}
            for k in in_keys
        ]
        supp_out = [
            {(s.lr_id << 1) | s.lr_strand for s in node.edges[0][k].edge_supp}
            for k in out_keys
        ]
        s00 = len(supp_in[0] & supp_out[0])
        s01 = len(supp_in[0] & supp_out[1])
        s10 = len(supp_in[1] & supp_out[0])
        s11 = len(supp_in[1] & supp_out[1])
        if log:
            log.write(
                f"node: {i}\n0-0 {s00}\n0-1 {s01}\n1-0 {s10}\n1-1 {s11}\n"
            )

        def split(in_key, out_key):
            new_id = len(graph)
            graph.append(bb.BBGNode(contig_id=graph[i].contig_id))
            _reroute(graph, in_key >> 1, in_key & 1, i, 1, new_id)
            _reroute(graph, out_key >> 1, out_key & 1, i, 0, new_id)

        if s00 > 2 * s01 or s11 > 2 * s10:
            split(in_keys[0], out_keys[0])
            resolved += 1
        if 2 * s00 < s01 or 2 * s11 < s10:
            split(in_keys[0], out_keys[1])
            resolved += 1
    return resolved


def _reroute(graph, node1, rev1, orig_node, orig_rev, copy_node):
    """Move the (node1 <-> orig_node) edge pair onto copy_node
    (``clean_update_edges``, Cleaning.cpp:651-664)."""
    to_orig = (node1 << 1) | rev1
    to_node1 = (orig_node << 1) | (1 - orig_rev)
    to_node2 = (copy_node << 1) | (1 - orig_rev)
    graph[copy_node].edges[orig_rev].set(
        to_orig, graph[orig_node].edges[orig_rev][to_orig]
    )
    graph[node1].edges[1 - rev1].set(
        to_node2, graph[node1].edges[1 - rev1][to_node1]
    )
    graph[orig_node].edges[orig_rev].remove(to_orig)
    graph[node1].edges[1 - rev1].remove(to_node1)
