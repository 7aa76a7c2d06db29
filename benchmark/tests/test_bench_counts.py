"""The roofline counts: a hand-built batch, and one count for both
engines."""

import pytest
import torch

from benchmark import counts
from benchmark.probes import Probes


def test_dp_cells_by_hand():
    # rows 8, W 32: 3 + 0 (negative) + 8 (clamped) + 7 rows of 32 cells
    assert counts.dp_cells([3, -1, 10, 7], rows=8, W=32) == 18 * 32
    peak = 132 * 64 * 1.98e9 * 2
    assert counts.dp_seconds(18 * 32) == pytest.approx(18 * 32 * 7 / peak)


def test_vote_tables_bytes_by_hand():
    B, N, S = 10, 2, 4
    read = 10 * 14 + 10 * 8 + 10 + 3 * 4
    written = 2 * 14 * 16 + (2 * 5 + 1) * 4 + 2 * 4
    assert counts.vote_tables_bytes(B, N, S) == read + written
    assert counts.bytes_seconds(3.35e12) == pytest.approx(1.0)


def test_both_engines_count_the_same_cells():
    """The same alignments handed to the row-scan and the wavefront
    launch entries count the same DP cells, and counts.dp_cells's."""
    r_lens = torch.tensor([100, 37, 0, 600, 512], dtype=torch.int32)
    reads = torch.zeros((5, 512), dtype=torch.uint8)
    drafts = torch.zeros((5, 540), dtype=torch.uint8)
    d_lens = torch.tensor([98, 40, 0, 530, 515], dtype=torch.int32)
    p = Probes([])
    launch = p._count_launch(lambda *a, **kw: None)
    launch("rowscan_cigar", {}, reads, r_lens, drafts, d_lens, 128)
    launch("wavefront_mapping", {}, reads, r_lens, drafts, d_lens, 128)
    want = counts.dp_cells(r_lens.tolist(), 512, 128)
    assert p.cells == {"rowscan_cigar": want, "wavefront_mapping": want}
