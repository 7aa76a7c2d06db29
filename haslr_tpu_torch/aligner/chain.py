"""Anchor chaining (minimap2-style DP).

Anchors (same target, same relative strand) are sorted by (target_pos,
query_pos) and chained with the standard concave-gap score:
``f[i] = max_j f[j] + min(dq, dt, k) - gap_cost(|dq - dt|)`` over a bounded
predecessor window — O(n * H) with H = 50, matching minimap2's practical
bound.  The inner max is numpy-vectorized over the predecessor window.
"""

from __future__ import annotations

import numpy as np


def gap_cost(diff: np.ndarray, k: int) -> np.ndarray:
    d = np.abs(diff).astype(np.float64)
    c = 0.01 * k * d + 0.5 * np.log2(d + 1)
    return np.where(d == 0, 0.0, c)


def chain_anchors(
    t_pos: np.ndarray,
    q_pos: np.ndarray,
    k: int,
    window: int = 50,
    max_gap: int = 5000,
    min_score: float = 40.0,
    min_anchors: int = 3,
):
    """Chain one (target, strand) group's anchors.

    Returns a list of chains, each ``(score, anchor_indices)`` with indices
    into the *sorted* order; chains are disjoint over anchors, emitted
    best-first.  Input arrays must be pre-sorted by (t_pos, q_pos).

    Dispatches to the native C++ DP (haslr_tpu_torch.native.chain_anchors_native,
    same semantics) when the library is available.
    """
    n = len(t_pos)
    if n == 0:
        return []
    from haslr_tpu_torch import native

    res = native.chain_anchors_native(
        t_pos, q_pos, k, window, max_gap, min_score, min_anchors
    )
    if res is not None:
        return res
    f = np.full(n, float(k))
    pred = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        j0 = max(0, i - window)
        dq = q_pos[i] - q_pos[j0:i]
        dt = t_pos[i] - t_pos[j0:i]
        ok = (dq > 0) & (dt > 0) & (dq < max_gap) & (dt < max_gap)
        if not ok.any():
            continue
        alpha = np.minimum(np.minimum(dq, dt), k)
        cand = f[j0:i] + alpha - gap_cost(dq - dt, k)
        cand = np.where(ok, cand, -np.inf)
        best = int(np.argmax(cand))
        if cand[best] > f[i]:
            f[i] = cand[best]
            pred[i] = j0 + best
    # extract chains best-first over unused anchors; a chain truncated at an
    # already-used anchor only keeps its own marginal score (otherwise every
    # anchor feeding the primary chain spawns a phantom duplicate chain
    # carrying the primary's score)
    used = np.zeros(n, dtype=bool)
    order = np.argsort(-f, kind="stable")
    chains = []
    for i in order:
        if used[i] or f[i] < min_score:
            continue
        idx = []
        j = i
        while j != -1 and not used[j]:
            idx.append(j)
            j = pred[j]
        marginal = float(f[i]) - (float(f[j]) if j != -1 else 0.0)
        for jj in idx:
            used[jj] = True
        if len(idx) < min_anchors or marginal < min_score:
            continue
        idx.reverse()
        chains.append((marginal, np.array(idx, dtype=np.int64)))
    return chains
