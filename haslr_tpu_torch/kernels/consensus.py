"""Batched window consensus (port of :mod:`haslr_tpu.kernels.consensus`).

The dense engine only (:mod:`haslr_tpu_torch.kernels.consensus_dense`).
The reference's chunked round-1 engine (``_one_round``, ``_Pileup``) and
``kernels/pileup.py`` are left out of the port: the dense engine is the
production path, and the reference holds the two engines equal.
"""

from __future__ import annotations

import torch

from haslr_tpu_torch.core import seq as cseq
from haslr_tpu_torch.dist.mesh import Mesh
from haslr_tpu_torch.kernels.consensus_dense import dense_consensus


def batched_consensus(
    windows: list[list[str]],
    match: int = 5,
    mismatch: int = -4,
    gap: int = -8,
    rounds: int = 2,
    warn=None,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> list[str]:
    """Consensus string per window (a list of supporting subsequences),
    polished on ``device`` (the card unless the caller says ``"cpu"``)
    or, given a ``dp`` ``mesh``, with the reads split over its devices
    and the same output."""
    window_codes = [
        [cseq.encode(s) for s in seqs if len(s) > 0] for seqs in windows
    ]
    drafts = dense_consensus(window_codes, match, mismatch, gap, rounds,
                             warn=warn, device=device, mesh=mesh)
    return [cseq.decode(d) for d in drafts]
