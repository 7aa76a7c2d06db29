"""Minimal example of the summed-support pattern, not the production path
(port of :mod:`haslr_tpu.dist.consensus_step`).

The production sharded consensus is the round loop of
:mod:`haslr_tpu_torch.kernels.consensus_dense` (reads split over the
mesh, vote tables summed each round, drafts copied back to every shard);
this module is the same pattern cut down to one readable step:

- a batch of (read-window, draft) pairs splits over the mesh's devices
  in contiguous blocks (:func:`shard_batch`);
- each device scores its block with the score-only banded NW
  (:func:`haslr_tpu_torch.kernels.nw.nw_scores`) and counts, per backbone
  edge, the reads whose score reaches ``min_score``;
- the per-edge counts are summed on the mesh's first device, as edge
  support is made global before the graph cleaning.
"""

from __future__ import annotations

import numpy as np
import torch

from haslr_tpu_torch.dist.mesh import Mesh
from haslr_tpu_torch.kernels import nw


def consensus_support_step(reads, r_lens, drafts, d_lens, edge_ids, n_edges,
                           W=128, min_score=0):
    """One shard's work: NW scores (B,) int32 and its local per-edge
    support (n_edges,) int32; edge ids outside ``[0, n_edges)`` count
    nowhere."""
    scores = nw.nw_scores(reads, r_lens, drafts, d_lens, W=W)
    ids = edge_ids.to(torch.int64)
    good = (scores >= min_score) & (ids >= 0) & (ids < n_edges)
    supp = torch.zeros(n_edges + 1, dtype=torch.int32, device=scores.device)
    supp.index_add_(0, torch.where(good, ids, n_edges),
                    torch.ones_like(ids, dtype=torch.int32))
    return scores, supp[:n_edges]


def make_sharded_step(mesh: Mesh, n_edges: int, W: int = 128):
    """The multi-device step: takes the per-shard lists of
    :func:`shard_batch` and returns ``(scores, support)`` on the mesh's
    first device, the scores in row order and the support summed over
    the shards.  Every shard is dispatched before any is merged."""

    def step(reads, r_lens, drafts, d_lens, edge_ids):
        parts = [
            consensus_support_step(*shard, n_edges, W=W)
            for shard in zip(reads, r_lens, drafts, d_lens, edge_ids)
        ]
        home = mesh.devices[0]
        scores = torch.cat([s.to(home) for s, _ in parts])
        supp = sum(p.to(home) for _, p in parts)
        return scores, supp

    return step


def shard_batch(mesh: Mesh, arrays):
    """Host arrays as per-shard tensor lists: the batch axis split into
    the mesh's contiguous blocks, one on each mesh device; a 0-d array
    goes whole to every device."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.ndim == 0:
            out.append([torch.from_numpy(a).to(d) for d in mesh.devices])
            continue
        out.append([torch.from_numpy(a[lo:hi]).to(d)
                     for (lo, hi), d in zip(mesh.blocks(len(a)),
                                            mesh.devices)])
    return tuple(out)
