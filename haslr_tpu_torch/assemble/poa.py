"""Partial-order-alignment consensus (exact host engine).

Replaces the vendored SPOA v1.1.3 library the reference links against
(``Assemble.cpp:499-555``: global alignment, match 5, mismatch -4, gap -8,
``align_sequence_with_graph`` + ``add_alignment`` per supporting subsequence,
then ``generate_consensus``).  This is a from-scratch POA:

- a DAG of single-base nodes with weighted edges (weight = number of
  sequences traversing the edge) and "aligned-node" groups (bases of
  different sequences aligned to the same column);
- global (NW) sequence-to-graph alignment with linear gaps.  Each DP row is
  vectorized over the sequence axis; the intra-row insertion recurrence is
  solved in closed form with a running-max scan
  (``H[j] = g*j + max_{k<=j}(tmp[k] - g*k)``), so alignment is O(nodes)
  numpy ops instead of O(nodes * len) Python;
- consensus by heaviest-bundle traversal (Lee 2003): the max-weight path
  through the DAG.

The TPU batch engine (``haslr_tpu_torch.kernels``) produces consensus for many
windows in parallel; this engine is the reference implementation and the
default for tiny inputs.
"""

from __future__ import annotations

import numpy as np

from haslr_tpu_torch.core import seq as cseq

NEG = -(10**9)


class PoaGraph:
    def __init__(self, match: int = 5, mismatch: int = -4, gap: int = -8):
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.base: list[int] = []          # 2-bit code per node
        self.in_edges: list[dict] = []     # node -> {pred: weight}
        self.out_edges: list[dict] = []    # node -> {succ: weight}
        self.aligned: list[list[int]] = [] # aligned-node groups
        self.n_seqs = 0

    # -- construction -------------------------------------------------------

    def _new_node(self, code: int) -> int:
        self.base.append(int(code))
        self.in_edges.append({})
        self.out_edges.append({})
        self.aligned.append([])
        return len(self.base) - 1

    def _add_edge(self, u: int, v: int):
        self.out_edges[u][v] = self.out_edges[u].get(v, 0) + 1
        self.in_edges[v][u] = self.in_edges[v].get(u, 0) + 1

    def _topo_order(self) -> list[int]:
        n = len(self.base)
        indeg = [len(self.in_edges[i]) for i in range(n)]
        stack = [i for i in range(n) if indeg[i] == 0]
        order = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in self.out_edges[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        return order

    # -- alignment ----------------------------------------------------------

    def align(self, codes: np.ndarray):
        """Global sequence-to-graph alignment.

        Returns a list of (node_id | None, seq_pos | None) pairs: both set
        for a diagonal move, node-only for a deletion (graph base skipped),
        pos-only for an insertion (sequence base not in graph).
        """
        m = len(codes)
        order = self._topo_order()
        n = len(order)
        rank = {u: r for r, u in enumerate(order)}
        g = self.gap
        jj = np.arange(m + 1, dtype=np.int64)

        # H[0] = virtual start row; H[r+1] = row of node order[r]
        H = np.empty((n + 1, m + 1), dtype=np.int64)
        H[0] = g * jj
        sub = np.where(
            codes[None, :] == np.arange(4)[:, None], self.match, self.mismatch
        )  # (4, m) substitution score per base code
        for r, u in enumerate(order):
            preds = self.in_edges[u]
            if preds:
                pred_rows = H[[rank[p] + 1 for p in preds]]
                best_pred = pred_rows.max(axis=0)
            else:
                best_pred = H[0]
            tmp = np.empty(m + 1, dtype=np.int64)
            tmp[0] = best_pred[0] + g
            diag = best_pred[:-1] + sub[self.base[u]]
            dele = best_pred[1:] + g
            tmp[1:] = np.maximum(diag, dele)
            # insertion scan: H[j] = max(tmp[j], H[j-1] + g) in closed form
            u_arr = tmp - g * jj
            H[r + 1] = g * jj + np.maximum.accumulate(u_arr)

        # pick best end: global alignment ends at a node with no out-edges
        ends = [u for u in order if not self.out_edges[u]]
        best_u = max(ends, key=lambda u: (H[rank[u] + 1][m], -rank[u]))

        # traceback (diagonal preferred, then deletion, then insertion)
        pairs = []
        u: int | None = best_u
        j = m
        while True:
            if u is None:
                # reached the virtual start: any remaining prefix is insertions
                while j > 0:
                    pairs.append((None, j - 1))
                    j -= 1
                break
            r = rank[u] + 1
            h = H[r][j]
            plist = (
                [(p, rank[p] + 1) for p in self.in_edges[u]]
                if self.in_edges[u]
                else [(None, 0)]
            )
            move = None
            if j > 0:
                s = self.match if self.base[u] == codes[j - 1] else self.mismatch
                for p, pr in plist:
                    if h == H[pr][j - 1] + s:
                        move = ("diag", p)
                        break
            if move is None:
                for p, pr in plist:
                    if h == H[pr][j] + g:
                        move = ("del", p)
                        break
            if move is None:
                if j > 0 and h == H[r][j - 1] + g:
                    pairs.append((None, j - 1))
                    j -= 1
                    continue
                raise AssertionError("POA traceback stuck")
            kind, p = move
            if kind == "diag":
                pairs.append((u, j - 1))
                j -= 1
            else:
                pairs.append((u, None))
            u = p
        pairs.reverse()
        return pairs

    # -- graph update -------------------------------------------------------

    def add_sequence(self, codes: np.ndarray, pairs=None):
        """Thread a sequence into the graph along its alignment."""
        if len(codes) == 0:
            return
        if len(self.base) == 0:
            prev = None
            for c in codes:
                u = self._new_node(c)
                if prev is not None:
                    self._add_edge(prev, u)
                prev = u
            self.n_seqs += 1
            return
        if pairs is None:
            pairs = self.align(codes)
        prev = None
        for node_id, pos in pairs:
            if pos is None:
                continue  # deletion: no sequence base here
            c = int(codes[pos])
            if node_id is None:
                u = self._new_node(c)
            elif self.base[node_id] == c:
                u = node_id
            else:
                u = None
                for a in self.aligned[node_id]:
                    if self.base[a] == c:
                        u = a
                        break
                if u is None:
                    u = self._new_node(c)
                    group = [node_id] + list(self.aligned[node_id])
                    for a in group:
                        self.aligned[a].append(u)
                    self.aligned[u] = group
            if prev is not None:
                self._add_edge(prev, u)
            prev = u
        self.n_seqs += 1

    # -- consensus ----------------------------------------------------------

    def consensus_codes(self) -> np.ndarray:
        """Heaviest-bundle consensus: max edge-weight path through the DAG."""
        if len(self.base) == 0:
            return np.zeros(0, dtype=np.uint8)
        order = self._topo_order()
        score = {u: 0 for u in order}
        pred = {u: None for u in order}
        for u in order:
            for v, w in self.out_edges[u].items():
                cand = score[u] + w
                if cand > score[v] or (
                    cand == score[v]
                    and pred[v] is not None
                    and u < pred[v]
                ):
                    score[v] = cand
                    pred[v] = u
        best = max(order, key=lambda u: (score[u], -u))
        path = []
        u = best
        while u is not None:
            path.append(self.base[u])
            u = pred[u]
        path.reverse()
        return np.array(path, dtype=np.uint8)

    def consensus(self) -> str:
        return cseq.decode(self.consensus_codes())


def poa_consensus(
    seqs: list[str], match: int = 5, mismatch: int = -4, gap: int = -8
) -> str:
    """Consensus of a window's supporting subsequences (SPOA call pattern of
    ``Assemble.cpp:499-555``: align+add each non-empty sequence in order,
    then generate consensus)."""
    g = PoaGraph(match, mismatch, gap)
    added = 0
    for s in seqs:
        if len(s) > 0:
            g.add_sequence(cseq.encode(s))
            added += 1
    if added == 0:
        return ""
    return g.consensus()
