"""Batched window consensus (port of :mod:`haslr_tpu.kernels.consensus`).

The device-batched replacement for per-window SPOA (reference
``Assemble.cpp:479-560``): each window's supporting reads are encoded,
polished by the dense multi-round engine per length bucket on one device
or over a ``dp`` mesh (:mod:`haslr_tpu_torch.kernels.consensus_dense`),
and decoded back to strings.

The port has this one engine.  The reference's second, chunked engine
(one align + vote round a host hop, voted in a separate pileup) gives
the same output, was reached by no entry point, option or benchmark
cell, and ran no faster on the card, so it was not kept.
"""

from __future__ import annotations

import torch

from haslr_tpu_torch import trace
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
    and the same output; ``warn`` takes the cap/drop/split notices.
    Spans ``consensus.encode`` (the windows' strings to codes) and
    ``consensus.decode`` (the drafts back to strings)."""
    with trace.span("consensus.encode"):
        window_codes = [
            [cseq.encode(s) for s in seqs if len(s) > 0] for seqs in windows
        ]
    drafts = dense_consensus(window_codes, match, mismatch, gap, rounds,
                             warn=warn, device=device, mesh=mesh)
    return _decode(drafts)


def _decode(drafts) -> list[str]:
    """The drafts' codes as strings (span ``consensus.decode``)."""
    with trace.span("consensus.decode"):
        return [cseq.decode(d) for d in drafts]
