"""The yardstick of the kernels' rooflines: the work their inputs need,
counted the same whatever engine or kernel does it, and the card's peaks.

**Banded DP.**  The extension and the consensus align each row of a
batch globally inside a band of W columns a query row, with linear gap
costs: ``H[i][j] = max(H[i-1][j-1] + s(i, j), H[i-1][j] + g,
H[i][j-1] + g)``.  A row of the band is W cells, so a read of ``r_len``
rows needs ``r_len * W`` cells, under the row-scan engine (a row at a
time) and the wavefront engine (an anti-diagonal at a time) alike.  A
cell needs ``OPS_PER_CELL`` = 7 int32 operations: the substitution score
(a compare and a select), three candidate adds and two maxes; the
direction the traceback reads is which candidate the maxes kept, and no
further operation.  The count is of the recurrence, not of an
implementation's instructions, so a kernel that saves instructions
raises its share and never lowers its bound.

**Int32 peak.**  132 SMs x 64 int32 lanes x 1.98 GHz (the H100 SXM's
boost clock) x 2: Hopper's DPX instructions (``VIADDMNMX``, ``VIMNMX3``)
do an add and a max, or two maxes, in one lane-cycle, so the int32 pipe
can retire two of the counted operations a lane-cycle.  Counting one
would let a kernel built on DPX read above 100 %.  The card's power
limit is printed beside the numbers; a card held below 700 W reaches
less.

**Bytes.**  V1 (the consensus round's vote tables) is bound by memory:
each plane byte of the 3S + 2 used columns, the stats, the ok bytes and
the CSR row offsets read once, the five tables written once, over the
3.35 TB/s of HBM3 (NVIDIA's data sheet, H100 SXM).
"""

from __future__ import annotations

SMS, INT32_LANES, BOOST_HZ, OPS_A_LANE_CYCLE = 132, 64, 1.98e9, 2
PEAK_INT32_OPS_S = SMS * INT32_LANES * BOOST_HZ * OPS_A_LANE_CYCLE
PEAK_BYTES_S = 3.35e12
OPS_PER_CELL = 7


def dp_cells(r_lens, rows: int, W: int) -> int:
    """Cells of the band that a launch's reads need: each read's rows
    (its length, clamped to the launch's ``rows``) times W.  ``r_lens``
    is any sequence or array of lengths."""
    return sum(min(max(int(r), 0), rows) for r in r_lens) * W


def dp_seconds(cells: int) -> float:
    """Least seconds the card takes for ``cells`` DP cells."""
    return cells * OPS_PER_CELL / PEAK_INT32_OPS_S


def vote_tables_bytes(B: int, N: int, S: int) -> int:
    """Bytes V1 must move for one round of ``B`` rows in ``N`` windows
    at draft width ``S``."""
    read = B * (3 * S + 2) + B * 8 + B + (N + 1) * 4
    written = N * (3 * S + 2) * 16 + (N * (S + 1) + 1) * 4 + N * 4
    return read + written


def bytes_seconds(n_bytes: int) -> float:
    """Least seconds the card takes to move ``n_bytes``."""
    return n_bytes / PEAK_BYTES_S
