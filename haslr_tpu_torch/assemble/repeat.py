"""Repeat resolution via a long-read overlap graph in compact-anchor space.

Functional equivalent of the reference's experimental ``Graph_repeat.cpp``
(1.5k LoC shipped but excluded from the build, Makefile:30, main.cpp:11):
long reads are compared in *anchor space* (their compact chains of SR-
contig anchors) with an end-gap-free LCS (match 3, indel -1,
``Graph_repeat.cpp:8-122``), overlapping pairs form a bidirected overlap
graph (``asm_ovgrpah_add_edge``, :544-618), transitively reducible
(``asm_ovgraph_transitive_reduction``, :754-820), from which linear read
paths bridge repeat regions the backbone graph cannot.

Where the reference verifies candidate overlaps at base level through
minimap2's C API (``asm_is_overlap_spurious``, :341-411), we reuse our own
banded NW scorer.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

LCS_MATCH = 3
LCS_INDEL = -1


def _chain_keys(chain, reverse: bool):
    """(t_id, is_rev) anchor keys of a compact chain, optionally as the
    reverse complement (reversed order, flipped strands)."""
    if not reverse:
        return [(a.t_id, a.is_rev) for a in chain]
    return [(a.t_id, 1 - a.is_rev) for a in reversed(chain)]


def lcs_alignment(keys1, keys2):
    """End-gap-free anchor LCS (``lcs_alignment``, Graph_repeat.cpp:8-122).

    Returns (aln1, aln2, score): parallel index lists with -1 marking gaps.
    """
    m, n = len(keys1), len(keys2)
    lcs = np.zeros((m + 1, n + 1), dtype=np.int32)
    bt = np.full((m + 1, n + 1), b"L", dtype="S1")
    bt[:, 0] = b"U"
    bt[0, :] = b"L"
    for i in range(1, m + 1):
        k1 = keys1[i - 1]
        for j in range(1, n + 1):
            if k1 == keys2[j - 1]:
                lcs[i][j] = lcs[i - 1][j - 1] + LCS_MATCH
                bt[i][j] = b"D"
            elif lcs[i - 1][j] > lcs[i][j - 1]:
                lcs[i][j] = lcs[i - 1][j] + LCS_INDEL
                bt[i][j] = b"U"
            else:
                lcs[i][j] = lcs[i][j - 1] + LCS_INDEL
                bt[i][j] = b"L"
    # free end gaps (Graph_repeat.cpp:58-75)
    for i in range(m):
        if lcs[i][n] > lcs[i + 1][n]:
            lcs[i + 1][n] = lcs[i][n]
            bt[i + 1][n] = b"U"
    for j in range(n):
        if lcs[m][j] > lcs[m][j + 1]:
            lcs[m][j + 1] = lcs[m][j]
            bt[m][j + 1] = b"L"
    score = int(lcs[m][n])
    aln1, aln2 = [], []
    i, j = m, n
    while i > 0 or j > 0:
        d = bt[i][j]
        if d == b"L":
            aln1.append(-1)
            aln2.append(j - 1)
            j -= 1
        elif d == b"U":
            aln1.append(i - 1)
            aln2.append(-1)
            i -= 1
        else:
            aln1.append(i - 1)
            aln2.append(j - 1)
            i -= 1
            j -= 1
    aln1.reverse()
    aln2.reverse()
    return aln1, aln2, score


def overlap_type(aln1, aln2):
    """Classify the overlap from the end-gap pattern.

    Returns one of 'contained1' (lr1 inside lr2), 'contained2',
    'dovetail12' (suffix of lr1 overlaps prefix of lr2), 'dovetail21',
    or 'internal' (not a proper overlap).  Mirrors the role of
    ``asm_get_overlap_type`` (Graph_repeat.cpp:528-542).
    """
    # column types: aln2 == -1 -> lr1-only column (lr1 sticks out there)
    ov1_front = aln2[0] == -1
    ov2_front = aln1[0] == -1
    ov1_back = aln2[-1] == -1
    ov2_back = aln1[-1] == -1
    if not ov1_front and not ov1_back:
        return "contained1"  # lr1 lies inside lr2
    if not ov2_front and not ov2_back:
        return "contained2"
    if ov1_front and ov2_back:
        return "dovetail12"  # suffix of lr1 overlaps prefix of lr2
    if ov2_front and ov1_back:
        return "dovetail21"
    return "internal"


@dataclass
class OvEdge:
    is_transitive: int = 0
    aln1: list = field(default_factory=list)
    aln2: list = field(default_factory=list)


@dataclass
class OvNode:
    out: dict = field(default_factory=dict)      # key (lr2<<1)|rev2
    out_rev: dict = field(default_factory=dict)
    is_contained: bool = False


def candidate_pairs(compact_lr_list, restrict_to=None):
    """Read pairs sharing at least one anchor contig (bucket by t_id)."""
    by_contig = defaultdict(list)
    for rid, chain in enumerate(compact_lr_list):
        if restrict_to is not None and not restrict_to[rid]:
            continue
        for a in chain:
            by_contig[a.t_id].append(rid)
    pairs = set()
    for rids in by_contig.values():
        uniq = sorted(set(rids))
        for x in range(len(uniq)):
            for y in range(x + 1, len(uniq)):
                pairs.add((uniq[x], uniq[y]))
    return sorted(pairs)


def _min_match_anchors(aln1, aln2):
    return sum(1 for a, b in zip(aln1, aln2) if a != -1 and b != -1)


def build_overlap_graph(
    compact_lr_list,
    restrict_to=None,
    min_anchors: int = 2,
    min_score: int = 2 * LCS_MATCH,
):
    """Anchor-space overlap graph over (a subset of) the long reads.

    Follows the reference's structure (``asm_build_ovgraph_from_unused_lrs``
    Graph_repeat.cpp:1204+): LCS every candidate pair in both relative
    orientations, keep proper dovetails/containments, add bidirected edges.
    """
    n = len(compact_lr_list)
    graph = [OvNode() for _ in range(n)]
    for lr1, lr2 in candidate_pairs(compact_lr_list, restrict_to):
        k1 = _chain_keys(compact_lr_list[lr1], False)
        best = None
        for rev2 in (0, 1):
            k2 = _chain_keys(compact_lr_list[lr2], bool(rev2))
            aln1, aln2, score = lcs_alignment(k1, k2)
            if best is None or score > best[2]:
                best = (aln1, aln2, score, rev2)
        aln1, aln2, score, rev2 = best
        if score < min_score:
            continue
        if _min_match_anchors(aln1, aln2) < min_anchors:
            continue
        ot = overlap_type(aln1, aln2)
        if ot == "contained1":
            graph[lr1].is_contained = True
            continue
        if ot == "contained2":
            graph[lr2].is_contained = True
            continue
        if ot == "internal":
            continue
        inv1 = list(reversed(aln1))
        inv2 = list(reversed(aln2))
        if ot == "dovetail12":
            _add_edge(graph, lr1, 0, lr2, rev2, aln1, aln2, inv1, inv2)
        else:  # dovetail21: lr2 -> lr1
            _add_edge(graph, lr2, rev2, lr1, 0, aln2, aln1, inv2, inv1)
    return graph


def _add_edge(graph, lr1, rev1, lr2, rev2, aln1, aln2, inv1, inv2):
    """Bidirected edge + twin (``asm_ovgrpah_add_edge``,
    Graph_repeat.cpp:544-618)."""
    if graph[lr1].is_contained or graph[lr2].is_contained:
        return
    side1 = graph[lr1].out if rev1 == 0 else graph[lr1].out_rev
    side1[(lr2 << 1) | rev2] = OvEdge(0, aln1, aln2)
    # twin: lr2 traversed opposite
    if rev2 == 0:
        graph[lr2].out_rev[(lr1 << 1) | (1 - rev1)] = OvEdge(0, inv2, inv1)
    else:
        graph[lr2].out[(lr1 << 1) | (1 - rev1)] = OvEdge(0, inv2, inv1)


def transitive_reduction(graph):
    """Mark transitive edges (Myers-style,
    ``asm_ovgraph_transitive_reduction``, Graph_repeat.cpp:754-820): an
    edge a->c is transitive when some a->b and b->c exist."""
    n_marked = 0
    for i, node in enumerate(graph):
        for side in (node.out, node.out_rev):
            targets = set(side.keys())
            for key in targets:
                b, rev_b = key >> 1, key & 1
                b_side = graph[b].out if rev_b == 0 else graph[b].out_rev
                for key2 in b_side:
                    if key2 in targets and key2 != key:
                        if not side[key2].is_transitive:
                            side[key2].is_transitive = 1
                            n_marked += 1
    return n_marked


def map_read_to_path(chain, path_nodes, reverse: bool = False):
    """LCS of a compact read chain against a simple path's anchor sequence
    (functional equivalent of ``Align_LR2path.cpp:16-356``: map LRs onto
    simple paths via compact-space LCS).

    ``path_nodes`` is a list of (contig_id, strand) pairs.  Returns
    (aln_read, aln_path, score).
    """
    k1 = _chain_keys(chain, reverse)
    k2 = [(int(n), int(s)) for n, s in path_nodes]
    return lcs_alignment(k1, k2)


def bridge_simple_paths(
    path_list,
    compact_lr_list,
    used_mask=None,
    min_support: int = 2,
    min_anchors: int = 2,
):
    """Find read-supported joins between simple-path ends.

    The capability of the reference's ``Align_LR2path.cpp:510+`` (bridge
    simple paths through repeat regions): every read is LCS-mapped against
    candidate paths in both orientations; a read whose alignment dovetails
    off the end of one path and onto the start of another supports the
    join (end_a -> start_b).  Returns a list of
    ``((path_a, side_a), (path_b, side_b), support)`` sorted by support —
    side 0 joins at the path's start, 1 at its end.
    """
    # index paths by member contig for candidate lookup
    by_contig = defaultdict(set)
    for pi, path in enumerate(path_list):
        for n, _s in path:
            by_contig[int(n)].add(pi)
    votes = defaultdict(int)
    for rid, chain in enumerate(compact_lr_list):
        if used_mask is not None and used_mask[rid]:
            continue
        if len(chain) < min_anchors:
            continue
        cands = set()
        for a in chain:
            cands |= by_contig.get(a.t_id, set())
        if len(cands) < 2:
            continue
        # find paths this read dovetails with, per orientation
        hits = []  # (path_idx, 'prefix'|'suffix' of the READ that matched)
        for pi in cands:
            best = None
            for rev in (False, True):
                a1, a2, score = map_read_to_path(chain, path_list[pi], rev)
                if best is None or score > best[2]:
                    best = (a1, a2, score, rev)
            a1, a2, score, rev = best
            if _min_match_anchors(a1, a2) < min_anchors:
                continue
            ot = overlap_type(a1, a2)
            if ot == "dovetail12":
                # read suffix overlaps path prefix: join at path start
                hits.append((pi, 0, "suffix"))
            elif ot == "dovetail21":
                hits.append((pi, 1, "prefix"))
            elif ot == "contained2":
                # whole path inside the read: both ends reachable
                hits.append((pi, 0, "suffix"))
                hits.append((pi, 1, "prefix"))
        # a read bridging (end of path A) -> (start of path B)
        ends = [(pi, side) for pi, side, part in hits if side == 1]
        starts = [(pi, side) for pi, side, part in hits if side == 0]
        for pa, _ in ends:
            for pb, _ in starts:
                if pa != pb:
                    votes[((pa, 1), (pb, 0))] += 1
    bridges = [
        (a, b, n) for (a, b), n in votes.items() if n >= min_support
    ]
    bridges.sort(key=lambda x: -x[2])
    return bridges


def extract_read_paths(graph):
    """Linear read paths over non-transitive edges
    (``asm_ovgraph_get_paths``, Graph_repeat.cpp:917+ simplified):
    follow unique non-transitive out-edges from unbranched starts."""

    def live_edges(node, rev):
        side = node.out if rev == 0 else node.out_rev
        return [(k >> 1, k & 1) for k, e in side.items()
                if not e.is_transitive]

    n = len(graph)
    indeg = defaultdict(int)
    for i, node in enumerate(graph):
        for rev in (0, 1):
            for nxt, nrev in live_edges(node, rev):
                indeg[(nxt, nrev)] += 1
    visited = set()
    paths = []
    for i in range(n):
        if graph[i].is_contained:
            continue
        for rev in (0, 1):
            outs = live_edges(graph[i], rev)
            if len(outs) != 1 or indeg[(i, rev)] > 0 or i in visited:
                continue
            path = [(i, rev)]
            visited.add(i)
            curr, crev = outs[0]
            while curr not in visited:
                path.append((curr, crev))
                visited.add(curr)
                nxt = live_edges(graph[curr], crev)
                if len(nxt) != 1:
                    break
                curr, crev = nxt[0]
            if len(path) > 1:
                paths.append(path)
    return paths


def _variant(path, orient: int):
    """A path's anchor list in one of its two walk orientations."""
    if orient == 0:
        return [(int(n), int(s)) for n, s in path]
    return [(int(n), 1 - int(s)) for n, s in reversed(path)]


def _twin_bridge(bridge):
    (pa, oa), (pb, ob), route = bridge
    tr = tuple((n, 1 - s) for n, s in reversed(route))
    return ((pb, 1 - ob), (pa, 1 - oa), tr)


def _canon_bridge(bridge):
    return min(bridge, _twin_bridge(bridge))


def find_path_bridges(graph, path_list, compact_lr_list, min_flank=2):
    """Read-supported joins between simple-path ends THROUGH the graph.

    The wired-up form of the reference's excluded ``Align_LR2path``
    capability (bridge simple paths through repeat paths,
    Align_LR2path.cpp:510+): a long read whose compact anchor chain exits
    one path's terminal anchors, walks a route of still-present (branching
    / repeat) edges, and enters another path's first anchors supports
    joining the two paths through that route.

    Returns ``{canonical_bridge: set(read_ids)}`` where a bridge is
    ``((path_a, orient_a), (path_b, orient_b), route)`` — join the END of
    variant a to the START of variant b via the ``route`` interior anchors
    (possibly empty).  Every route edge is verified to exist in the
    cleaned graph.
    """
    from haslr_tpu_torch.assemble import backbone as bb

    variants = [
        (_variant(p, 0), _variant(p, 1)) for p in path_list
    ]
    end_idx = defaultdict(list)    # last anchor of a variant -> (pi, o)
    start_idx = defaultdict(list)  # first anchor of a variant -> (pi, o)
    for pi, (fwd, rev) in enumerate(variants):
        for o, var in ((0, fwd), (1, rev)):
            end_idx[var[-1]].append((pi, o))
            start_idx[var[0]].append((pi, o))

    def flank_ok(keys, i, var, at_end):
        k = min(min_flank, len(var))
        if at_end:  # var's last k anchors must match keys[i-k+1 .. i]
            if i - k + 1 < 0:
                return False
            return list(var[-k:]) == keys[i - k + 1 : i + 1]
        if i + k > len(keys):
            return False
        return list(var[:k]) == keys[i : i + k]

    def route_exists(anchors):
        for (u, su), (v, sv) in zip(anchors, anchors[1:]):
            if bb.edge_key(v, sv) not in graph[u].edges[su]:
                return False
        return True

    supp = defaultdict(set)
    for rid, chain in enumerate(compact_lr_list):
        if len(chain) < 2:
            continue
        for orient in (False, True):
            keys = _chain_keys(chain, orient)
            for i in range(len(keys) - 1):
                ends = [
                    (pi, o) for pi, o in end_idx.get(keys[i], ())
                    if flank_ok(keys, i, variants[pi][o], at_end=True)
                ]
                if not ends:
                    continue
                # nearest following path-start on this read
                for j in range(i + 1, len(keys)):
                    starts = [
                        (pi, o) for pi, o in start_idx.get(keys[j], ())
                        if flank_ok(keys, j, variants[pi][o], at_end=False)
                    ]
                    if starts:
                        break
                else:
                    continue
                route = tuple(keys[i + 1 : j])
                if not route_exists([keys[i], *route, keys[j]]):
                    continue
                for pa, oa in ends:
                    for pb, ob in starts:
                        if pa == pb:
                            continue
                        b = _canon_bridge(((pa, oa), (pb, ob), route))
                        supp[b].add(rid)
    return supp


def merge_bridged_paths(
    graph, path_list, compact_lr_list, min_support: int = 2,
    min_flank: int = 2, log=None,
):
    """Concatenate simple paths through read-supported repeat routes.

    Bridges from :func:`find_path_bridges` with at least ``min_support``
    reads are applied greedily (highest support first) with each path end
    consumed at most once; chains of bridges merge transitively.  Route
    interior nodes (the repeat copies) may appear in several merged paths
    — that is the repeat resolution.  Singleton paths whose node became a
    route interior are dropped.  Returns the new path list (deques, same
    element type as the input).
    """
    from collections import deque

    bridges = find_path_bridges(
        graph, path_list, compact_lr_list, min_flank=min_flank
    )
    ranked = sorted(
        ((len(rids), b) for b, rids in bridges.items()),
        key=lambda x: (-x[0], x[1]),
    )

    conts = {
        pi: {
            "nodes": _variant(p, 0),
            "members": [pi],
            "left": (pi, 0),
            "right": (pi, 0),
        }
        for pi, p in enumerate(path_list)
    }
    where = {pi: pi for pi in conts}
    route_nodes = set()

    def flip(c):
        c["nodes"] = [(n, 1 - s) for n, s in reversed(c["nodes"])]
        lpi, lo = c["left"]
        rpi, ro = c["right"]
        c["left"], c["right"] = (rpi, 1 - ro), (lpi, 1 - lo)

    n_merged = 0
    for n_supp, ((pa, oa), (pb, ob), route) in ranked:
        if n_supp < min_support:
            break
        ca, cb = where.get(pa), where.get(pb)
        if ca is None or cb is None or ca == cb:
            continue
        A, B = conts[ca], conts[cb]
        if A["right"] == (pa, oa):
            pass
        elif A["left"] == (pa, 1 - oa):
            flip(A)
        else:
            continue  # that end was already consumed
        if B["left"] == (pb, ob):
            pass
        elif B["right"] == (pb, 1 - ob):
            flip(B)
        else:
            continue
        if log is not None:
            print(
                f"bridge path:{pa} -> path:{pb} via {list(route)} "
                f"support:{n_supp}",
                file=log,
            )
        A["nodes"] = A["nodes"] + list(route) + B["nodes"]
        A["members"] += B["members"]
        A["right"] = B["right"]
        for pi in B["members"]:
            where[pi] = ca
        del conts[cb]
        route_nodes.update(n for n, _s in route)
        n_merged += 1

    out = []
    emitted = set()
    for pi, p in enumerate(path_list):
        ci = where[pi]
        if ci in emitted:
            continue
        c = conts[ci]
        if len(c["members"]) == 1:
            nodes = c["nodes"]
            if len(nodes) == 1 and nodes[0][0] in route_nodes:
                emitted.add(ci)
                continue  # singleton absorbed as a route interior
            out.append(deque(p))  # untouched original
        else:
            out.append(deque(c["nodes"]))
        emitted.add(ci)
    if log is not None:
        print(f"merged {n_merged} bridges", file=log)
    return out
