"""Backbone anchor graph over unique short-read contigs.

Replaces reference ``Backbone_graph.cpp``.  One node per SR contig; each
node has two edge maps (``edges[0]`` = edges leaving the forward
orientation, ``edges[1]`` = leaving the reverse orientation); edge keys are
``(node2 << 1) | strand2`` and every undirected edge is stored twice (edge +
twin) with mirrored support records (``bbg_add_edge``,
Backbone_graph.cpp:10-25).

Iteration order matters: the reference's ``std::map`` iterates keys
ascending, and cleaning heuristics pick ``begin()``/second element —
:class:`EdgeMap` preserves that exactly via a sorted key list.
"""

from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field


@dataclass
class EdgeSupp:
    """One supporting long read of an edge (``Edge_Supp_t``,
    Backbone_graph.hpp:23-29)."""

    lr_id: int
    lr_strand: int
    cmp_head_id: int  # index of the head anchor in the read's compact chain
    cmp_tail_id: int


@dataclass
class CnsSupp:
    """One long-read subsequence supporting an edge's consensus
    (``Consensus_Supp_t``, Backbone_graph.hpp:31-37)."""

    lr_id: int
    lr_strand: int
    spos: int  # inclusive
    epos: int  # inclusive


@dataclass
class BBGEdge:
    """``BBG_Edge_t`` (Backbone_graph.hpp:39-47)."""

    edge_supp: list = field(default_factory=list)
    cns_supp: list = field(default_factory=list)
    head_end: int = 0   # last shared position on the head contig
    tail_beg: int = 0   # first shared position on the tail contig
    cns_seq: str = ""
    flag: int = 0


class EdgeMap:
    """Ascending-key ordered map of edge-key -> BBGEdge (std::map analog)."""

    __slots__ = ("_keys", "_d")

    def __init__(self):
        self._keys: list[int] = []
        self._d: dict[int, BBGEdge] = {}

    def __len__(self):
        return len(self._d)

    def __contains__(self, key: int) -> bool:
        return key in self._d

    def __getitem__(self, key: int) -> BBGEdge:
        return self._d[key]

    def get_or_create(self, key: int) -> BBGEdge:
        e = self._d.get(key)
        if e is None:
            e = BBGEdge()
            self._d[key] = e
            bisect.insort(self._keys, key)
        return e

    def set(self, key: int, edge: BBGEdge) -> None:
        if key not in self._d:
            bisect.insort(self._keys, key)
        self._d[key] = edge

    def remove(self, key: int) -> None:
        if key in self._d:
            del self._d[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def keys(self) -> list[int]:
        return list(self._keys)

    def items(self):
        for k in list(self._keys):
            yield k, self._d[k]

    def first_key(self) -> int:
        return self._keys[0]

    def nth_key(self, n: int) -> int:
        return self._keys[n]


@dataclass
class BBGNode:
    """``BBG_Node_t`` (Backbone_graph.hpp:49-54)."""

    contig_id: int = 0
    edges: tuple = None  # (EdgeMap outgoing-fwd, EdgeMap outgoing-rev)

    def __post_init__(self):
        if self.edges is None:
            self.edges = (EdgeMap(), EdgeMap())


def edge_key(node: int, strand: int) -> int:
    return (node << 1) | strand


def add_edge(graph, lr_id, lr_strand, compact_lr, index1, index2):
    """Add edge + twin for two consecutive anchors of one long read
    (``bbg_add_edge``, Backbone_graph.cpp:10-25)."""
    a1 = compact_lr[index1]
    a2 = compact_lr[index2]
    node1, rev1 = a1.t_id, a1.is_rev
    node2, rev2 = a2.t_id, a2.is_rev
    to1 = edge_key(node2, rev2)
    to2 = edge_key(node1, 1 - rev1)
    graph[node1].edges[rev1].get_or_create(to1).edge_supp.append(
        EdgeSupp(lr_id, lr_strand, index1, index2)
    )
    graph[node2].edges[1 - rev2].get_or_create(to2).edge_supp.append(
        EdgeSupp(lr_id, 1 - lr_strand, index2, index1)
    )


def add_edge_with_supp(graph, node1, rev1, node2, rev2, shared_supp):
    """``bbg_add_edge_with_supp`` (Backbone_graph.cpp:27-37)."""
    to1 = edge_key(node2, rev2)
    to2 = edge_key(node1, 1 - rev1)
    e1 = graph[node1].edges[rev1].get_or_create(to1)
    e2 = graph[node2].edges[1 - rev2].get_or_create(to2)
    for s in shared_supp:
        e1.edge_supp.append(
            EdgeSupp(s.lr_id, s.lr_strand, s.cmp_head_id, s.cmp_tail_id)
        )
        e2.edge_supp.append(
            EdgeSupp(s.lr_id, 1 - s.lr_strand, s.cmp_tail_id, s.cmp_head_id)
        )


def get_edge(graph, node1, rev1, node2, rev2) -> BBGEdge:
    return graph[node1].edges[rev1][edge_key(node2, rev2)]


def remove_edge(graph, node1, rev1, node2, rev2):
    """Remove edge + twin (``bbg_remove_edge``, Backbone_graph.cpp:45-51)."""
    graph[node1].edges[rev1].remove(edge_key(node2, rev2))
    graph[node2].edges[1 - rev2].remove(edge_key(node1, 1 - rev1))


def build_graph(contigs, compact_lr_list, uniq_freq, cfg) -> list[BBGNode]:
    """``bbg_build_graph`` (Backbone_graph.cpp:148-171): one edge per pair of
    consecutive *unique* anchors (mean_kmer <= uniq_freq*(1+dev)) on each
    compact long read."""
    graph = [BBGNode(contig_id=i) for i in range(len(contigs))]
    thresh = uniq_freq * (1 + cfg.max_uniq_dev)
    for rid, chain in enumerate(compact_lr_list):
        if len(chain) <= 1:
            continue
        sel = [
            j for j, a in enumerate(chain) if contigs.mean_kmer[a.t_id] <= thresh
        ]
        for k in range(len(sel) - 1):
            add_edge(graph, rid, 0, chain, sel[k], sel[k + 1])
    return graph


def remove_weak_edges(graph, min_edge_sup: int) -> int:
    """Drop edges with support below ``min_edge_sup``
    (``bbg_remove_weak_edges``, Backbone_graph.cpp:348-375)."""
    removed = 0
    for i, node in enumerate(graph):
        for rev1 in (0, 1):
            for key in node.edges[rev1].keys():
                if key not in node.edges[rev1]:
                    continue  # already removed as a twin
                if len(node.edges[rev1][key].edge_supp) < min_edge_sup:
                    node2, rev2 = key >> 1, key & 1
                    remove_edge(graph, i, rev1, node2, rev2)
                    removed += 1
    return removed


def find_simple_path_from_source(
    graph, src_node, src_strand, first_key, max_depth
):
    """Follow a simple path from ``src_node`` through edge ``first_key``.

    Reference ``bbg_find_simple_path_from_source``
    (Backbone_graph.cpp:378-402).  Returns ``(ok, path, cov)`` where ``ok``
    is False when the simple path exceeds ``max_depth``; ``path`` is a list
    of (node, strand); ``cov`` the mean support of traversed edges.
    """
    path = [(src_node, src_strand)]
    cov = 0.0
    edge = graph[src_node].edges[src_strand][first_key]
    curr_node, curr_strand = first_key >> 1, first_key & 1
    depth = 1
    while depth <= max_depth:
        path.append((curr_node, curr_strand))
        cov += len(edge.edge_supp)
        out = graph[curr_node].edges[curr_strand]
        inn = graph[curr_node].edges[1 - curr_strand]
        if len(out) == 0:
            break
        if len(out) > 1 or len(inn) > 1:
            break
        key = out.first_key()
        edge = out[key]
        curr_node, curr_strand = key >> 1, key & 1
        depth += 1
    if depth > max_depth:
        return False, path, 0.0
    return True, path, cov / depth


def find_next_edge(graph, curr_node, curr_strand):
    """Unique continuation edge key from (node, strand), or None
    (``bbg_find_next_edge``, Backbone_graph.cpp:404-431)."""
    node = graph[curr_node]
    if len(node.edges[0]) > 1 or len(node.edges[1]) > 1:
        return None
    if len(node.edges[curr_strand]) == 1:
        return node.edges[curr_strand].first_key()
    return None


def find_simple_paths2(graph):
    """Destructively peel simple paths from source/sink nodes
    (``bbg_find_simple_paths2``, Backbone_graph.cpp:434-537): starting from
    every node with edges on only one side, follow each of its edges to the
    end of its simple path, record the path, remove its edges, and re-queue
    freed endpoints.  Returns the list of paths as (node, strand) lists."""
    from collections import deque as _deque

    simple_paths = []
    to_explore = _deque()
    for i, node in enumerate(graph):
        if len(node.edges[1]) == 0 and len(node.edges[0]) > 0:
            to_explore.append((i, 0))
        elif len(node.edges[1]) > 0 and len(node.edges[0]) == 0:
            to_explore.append((i, 1))
    while to_explore:
        src_node, src_strand = to_explore.popleft()
        paths_curr = []
        for key in graph[src_node].edges[src_strand].keys():
            if key not in graph[src_node].edges[src_strand]:
                continue
            path = [(src_node, src_strand)]
            curr = key
            while True:
                nxt_node, nxt_strand = curr >> 1, curr & 1
                path.append((nxt_node, nxt_strand))
                curr = find_next_edge(graph, nxt_node, nxt_strand)
                if curr is None:
                    break
            paths_curr.append(path)
        for path in paths_curr:
            simple_paths.append(path)
            for j in range(len(path) - 1):
                remove_edge(
                    graph, path[j][0], path[j][1], path[j + 1][0],
                    path[j + 1][1],
                )
            last_node, last_strand = path[-1]
            out_n = len(graph[last_node].edges[0])
            in_n = len(graph[last_node].edges[1])
            if last_strand == 0 and out_n > 0 and in_n == 0:
                to_explore.append((last_node, last_strand))
            elif last_strand == 1 and out_n == 0 and in_n > 0:
                to_explore.append((last_node, last_strand))
    return simple_paths


def iter_all_edges(graph):
    """Yield (node1, rev1, key, edge) over every directed edge entry, in the
    reference's canonical order (vertex id, then ascending key)."""
    for i, node in enumerate(graph):
        for rev in (0, 1):
            for key, edge in node.edges[rev].items():
                yield i, rev, key, edge


def unique_edges(graph):
    """Yield each undirected edge once: (node1, rev1, node2, rev2, edge,
    twin_edge), in canonical order (first encounter wins)."""
    seen = set()
    for i, rev, key, edge in iter_all_edges(graph):
        node2, rev2 = key >> 1, key & 1
        twin_key = edge_key(i, 1 - rev)
        ident = (i, rev, key)
        twin_ident = (node2, 1 - rev2, twin_key)
        if twin_ident in seen:
            continue
        seen.add(ident)
        twin = graph[node2].edges[1 - rev2][twin_key]
        yield i, rev, node2, rev2, edge, twin


def write_gfa(graph, contigs, path: str) -> None:
    """GFA writer (``bbg_print_graph_gfa``, Backbone_graph.cpp:540-588):
    S-lines carry the full contig sequence + LN/KC tags for nodes on edges;
    every directed edge entry emits an L-line with 0M overlap."""
    with open(path, "w") as fp:
        to_print = set()
        for i, node in enumerate(graph):
            for rev in (0, 1):
                for key, _ in node.edges[rev].items():
                    to_print.add(i)
                    to_print.add(key >> 1)
        for i in sorted(to_print):
            cid = graph[i].contig_id
            s = contigs.get_str(cid)
            fp.write(
                f"S\t{i}\t{s}\tLN:i:{len(s)}\tKC:i:{contigs.kmer_count[cid]}\n"
            )
        for i, node in enumerate(graph):
            for rev in (0, 1):
                for key, _ in node.edges[rev].items():
                    fp.write(
                        f"L\t{i}\t{'+-'[rev]}\t{key >> 1}\t"
                        f"{'-' if key & 1 else '+'}\t0M\n"
                    )


def general_stats(graph, contigs, path: str) -> None:
    """Node/edge counts + connected components sorted by size
    (``bbg_general_stats``, Backbone_graph.cpp:595-659)."""
    n = len(graph)
    nb_node = sum(
        1 for g in graph if len(g.edges[0]) > 0 or len(g.edges[1]) > 0
    )
    nb_edge = sum(len(g.edges[0]) + len(g.edges[1]) for g in graph)
    visited = [False] * n
    components = []
    for i in range(n):
        if visited[i] or (len(graph[i].edges[0]) == 0 and len(graph[i].edges[1]) == 0):
            continue
        cc_size = contigs.length(graph[i].contig_id)
        cc_node = 1
        visited[i] = True
        q = deque([i])
        while q:
            curr = q.popleft()
            for rev in (0, 1):
                for key, _ in graph[curr].edges[rev].items():
                    nxt = key >> 1
                    if not visited[nxt]:
                        visited[nxt] = True
                        cc_node += 1
                        cc_size += contigs.length(graph[nxt].contig_id)
                        q.append(nxt)
        components.append((cc_size, cc_node, i))
    components.sort(key=lambda t: -t[0])
    with open(path, "w") as fp:
        fp.write(f"nodes: {nb_node}\n")
        fp.write(f"edges: {nb_edge // 2}\n")
        fp.write(f"connected_components: {len(components)}\n")
        for idx, (size, nodes, rep) in enumerate(components):
            fp.write(
                f"\tcomponent:{idx}\tsize:{size}\tnodes:{nodes}"
                f"\trepresentative:{rep}\n"
            )


def report_branching_nodes(graph, path: str) -> None:
    """``bbg_report_branching_nodes`` (Backbone_graph.cpp:682-694)."""
    with open(path, "w") as fp:
        for i, node in enumerate(graph):
            if len(node.edges[0]) >= 2 or len(node.edges[1]) >= 2:
                fp.write(
                    f"node:{i}\tincoming:{len(node.edges[0])}"
                    f"\toutgoing:{len(node.edges[1])}\n"
                )
