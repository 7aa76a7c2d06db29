"""Interval algorithms: weighted scheduling and best-supported intervals.

Host-side exact implementations of the reference's two interval routines,
with semantics (sort orders, tie-breaking, >= vs >) reproduced bit-for-bit:

- :func:`weighted_interval_scheduling` — the compaction DP of
  ``Longread.cpp:514-610`` (maximize matched bases over non-overlapping
  alignments of one long read).
- :func:`best_supported_interval` — the begin/end event sweep of
  ``Assemble.cpp:24-126`` in both variants (``>=`` for the head contig,
  ``>`` for the tail contig).

Inputs per call are small (alignments of one read / supports of one edge);
batched device versions for the hot path live in ``haslr_tpu_torch.kernels``.
"""

from __future__ import annotations

import numpy as np


def weighted_interval_scheduling(
    q_start: np.ndarray, q_end: np.ndarray, weight: np.ndarray
) -> list[int]:
    """Max-weight subset of non-overlapping intervals; returns chosen indices.

    Intervals must already be sorted by (q_end, q_start) — the reference
    sorts alignments once at PAF load (``Longread.cpp:253-256`` with
    ``compare_Align_Seg``) and the DP assumes that order.  Tie-breaking
    matches ``Longread.cpp:570-601``: an interval joins the solution only if
    it *strictly* improves the running optimum.

    Bounded resources by construction (a deliberate divergence from the
    reference, documented in docs/DESIGN.md): the C++ uses unchecked
    fixed ``dp[10000]`` stack arrays (Longread.cpp:528-529) — undefined
    behavior past 10,000 alignments — and O(n) tracked index lists per
    cell (O(n^2) memory).  This implementation stores parent pointers
    (O(n) memory) and vectorizes the predecessor scan for large n, while
    producing the identical selection for every in-bounds input.
    """
    n = len(q_start)
    if n == 0:
        return []
    q_start = np.asarray(q_start, dtype=np.int64)
    q_end = np.asarray(q_end, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.int64)

    # Latest compatible predecessor: the reference scans j from i-1 downward
    # and takes the first with q_end[j] <= q_start[i] (Longread.cpp:514-522),
    # i.e. the LARGEST such j.  We replicate that result rather than
    # bisecting on q_end because overlap fixing (fix_overlapping_alignments)
    # can perturb q_end after the initial sort, and the reference does not
    # re-sort (Longread.cpp:620).
    if n <= 256:
        def latest_compatible(i: int) -> int:
            for j in range(i - 1, -1, -1):
                if q_end[j] <= q_start[i]:
                    return j
            return -1
    else:
        def latest_compatible(i: int) -> int:
            ok = np.nonzero(q_end[:i] <= q_start[i])[0]
            return int(ok[-1]) if len(ok) else -1

    dp = np.zeros(n, dtype=np.int64)
    taken = np.zeros(n, dtype=bool)
    parent = np.full(n, -1, dtype=np.int64)
    dp[0] = weight[0]
    taken[0] = True
    for i in range(1, n):
        j = latest_compatible(i)
        base = dp[j] if j >= 0 else 0
        cand = weight[i] + base
        if cand > dp[i - 1]:
            dp[i] = cand
            taken[i] = True
            parent[i] = j
        else:
            dp[i] = dp[i - 1]
    # reconstruct the reference's track[n-1]
    out: list[int] = []
    i = n - 1
    while i >= 0:
        if taken[i]:
            out.append(i)
            i = int(parent[i])
        else:
            i -= 1
    out.reverse()
    return out


def best_supported_interval(
    begs: np.ndarray,
    ends: np.ndarray,
    ids: np.ndarray,
    strict: bool,
) -> tuple[int, int, set[int]]:
    """Max-overlap interval sweep over [beg, end) intervals.

    Reproduces ``asm_best_supported_interval_contig1`` (``strict=False``,
    update on ``>=``, Assemble.cpp:24-74) and ``..._contig2``
    (``strict=True``, update on ``>``, Assemble.cpp:76-126): begin and end
    event lists are sorted independently as (pos, id) pairs; the sweep tracks
    the live id set and snapshots it whenever the support improves.

    Returns ``(best_beg, best_end, best_ids)`` where ``best_ids`` holds the
    ``ids`` values live at the best begin event.
    """
    order_b = np.lexsort((ids, begs))
    order_e = np.lexsort((ids, ends))
    bl = [(int(begs[k]), int(ids[k])) for k in order_b]
    el = [(int(ends[k]), int(ids[k])) for k in order_e]

    best_supp = 0
    curr: set[int] = set()
    best: set[int] = set()
    beg_best = end_best = 0
    started = False
    i = j = 0
    n = len(bl)
    while i < n and j < n:
        if bl[i][0] < el[j][0]:
            curr.add(bl[i][1])
            supp = len(curr)
            if (supp > best_supp) if strict else (supp >= best_supp):
                best_supp = supp
                beg_best = bl[i][0]
                best = set(curr)
                started = True
            i += 1
        else:
            if started:
                end_best = el[j][0]
                started = False
            curr.discard(el[j][1])
            j += 1
    if started:
        end_best = el[j][0]
    return beg_best, end_best, best
